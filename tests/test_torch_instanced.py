"""Instanced scenes with cell lists in the port against vpt_tpu, on the CPU.

The host tables exactly (the octant extents, the majorant grid's
``packed``, ``cell_instances``, ``cell_rows``, ``max_density``,
``occupied``, ``skip_dist``, the instance rows) on the c5 golden's scene
(27 instances of the 12^3 blob) at R 16 (K = 3) and R 64 (K = 1) and on a
64-instance config 5 scene (bench.py's cloud_xforms) at R 32; the cell
fetch at random points and directions within rtol 1e-6 + atol 1e-7
(float32 rounding of the same operations; on the CPU they agree exactly); the
folded taus and cell_tau_fetch within test_torch_scene.py's TAU_RTOL /
TAU_ATOL; fused_direct ray by ray in both shadow modes with BLACK,
CONSTANT and the simple sky under test_torch_fused.py's rule (>= 99% of
rays agree: L within rtol 1e-4 + atol 1e-6, alpha within 1e-5, cost and
unfinished equal; image means within 0.5%), with test_torch_env.py's
SKY_RTOL for L under the sky, whose plain version differs from the
reference's by up to 2e-4 (its 99th percentile); the c5_instanced golden
through the port at tol_scale 1; what still raises (bfloat16 rows and
octant columns, ROADMAP A.10); and `.ins` files.  Several grids, the
static per-instance loop, emission and color: build_atlas on three grids,
the instance rows and packed majorant rows, local_majorant_query and
empty_skip_t, scene_density / scene_emission / scene_color on both
branches, and world_tau_fetch exactly, the world tau bake within 1e-6;
fused_direct ray by ray on the loop, loop x EXT, cells x EXT and
volume_depth 2 by the same rule.  Reference scenes are carried over by
scene_from_arrays, so both packages render the same tables; cached runs
use the reference's own taus.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpt_tpu.app.cli as jcli
import vpt_tpu_torch.app.cli as tcli
from tests.golden_scenes import BASE_KW, SPP, _blob, _camera
from tests.test_golden import GOLDEN_DIR, _compare
from tests.test_torch_env import SKY_RTOL
from tests.test_torch_scene import TAU_ATOL, TAU_RTOL
from tests.torch_parity import agreement, jax_scene_arrays, radiance_share
from vpt_tpu.accel import majorant as jmajorant
from vpt_tpu.accel import shadow as jshadow
from vpt_tpu.render import tracking as jtracking
from vpt_tpu.render.fused import fused_direct as j_fused
from vpt_tpu.render.params import Environment as JEnv
from vpt_tpu.render.params import RenderParams as JParams
from vpt_tpu.scene import ins as jins
from vpt_tpu.scene.scene import build_scene as jbuild
from vpt_tpu.utils.exr import read_exr_rgb
from vpt_tpu.volume import grid as jgrid
from vpt_tpu.volume import procedural as jproc
from vpt_tpu_torch.accel import majorant as tmajorant
from vpt_tpu_torch.accel import shadow as tshadow
from vpt_tpu_torch.render import fused as t_fused
from vpt_tpu_torch.render import tracking as ttracking
from vpt_tpu_torch.render.params import RenderParams as TParams
from vpt_tpu_torch.render.renderer import ProgressiveRenderer as TRenderer
from vpt_tpu_torch.scene import ins as tins
from vpt_tpu_torch.scene.convert import scene_from_arrays
from vpt_tpu_torch.scene.scene import build_scene as tbuild
from vpt_tpu_torch.tools import common
from vpt_tpu_torch.volume import grid as tgrid
from vpt_tpu_torch.volume import procedural as tproc

MIN_SHARE, MAX_MEAN_REL = 0.99, 0.005
FETCH_RTOL, FETCH_ATOL = 1e-6, 1e-7
BAKE = dict(azimuth=150.0, elevation=30.0, world_resolution=32)
ENVS = {"black": int(JEnv.BLACK), "constant": int(JEnv.CONSTANT),
        "sky": int(JEnv.ATMOSPHERE)}


def _c5(R, port=False):
    """The c5 golden's scene at majorant resolution R, built by the
    reference (framed as the golden frames it) or by the port."""
    ids, xforms = common.golden_c5_instances()
    kw = dict(instance_grid_ids=ids, instance_xforms=xforms,
              majorant_resolution=R)
    if port:
        return tbuild([_blob(n=12)], device="cpu", **kw)
    return _camera(jbuild([_blob(n=12)], **kw))


def _cloud64(port=False):
    """64 of config 5's instances of the 24^3 puff at R 32."""
    ids, xforms = common.cloud_xforms(64)
    kw = dict(instance_grid_ids=ids, instance_xforms=xforms,
              majorant_resolution=32)
    g = common.bench_blob(n=24)
    return tbuild([g], device="cpu", **kw) if port else jbuild([g], **kw)


def _carry(js):
    return scene_from_arrays(jax_scene_arrays(js), device="cpu")


@pytest.fixture(scope="module")
def c5():
    """{name: scene}: the reference's c5 scene at R 16, bare and baked,
    each carried over; the port's own build and bake of it."""
    js = _c5(16)
    jb = jshadow.attach_shadow_cache(js, **BAKE)
    ts = _c5(16, port=True)
    return dict(js=js, jb=jb, cs=_carry(js), cb=_carry(jb), ts=ts,
                tb=tshadow.attach_shadow_cache(ts, **BAKE))


OCC_CASES = {"sparse": ((13, 11, 9), 0.05), "dense": ((8, 12, 10), 0.3),
             "flat": ((20, 1, 17), 0.05), "blob": None}


@pytest.mark.parametrize("case", list(OCC_CASES))
def test_octant_box_extents_exact(case):
    """The 72 octant columns of the torch sweep equal the reference's
    (its native sweep, or the numpy fallback) on random occupancies and
    on the blob's."""
    if OCC_CASES[case] is None:
        occ = _blob(n=20).density_zyx > 0.3
    else:
        shape, p = OCC_CASES[case]
        occ = np.random.default_rng(len(case)).random(shape) < p
    want = jgrid._octant_box_extents(occ)
    got = tgrid._octant_box_extents(occ, device="cpu")
    assert got.shape == (72,) + occ.shape and (want > 0).any()
    np.testing.assert_array_equal(got, want)


def test_octant_exit_exact():
    """octant_exit's indexed pick equals the reference's where-tree, on
    zero direction components and major-axis ties too."""
    r = np.random.default_rng(2)
    n = 4096
    rows = r.integers(-1, 9, (n, 72)).astype(np.float32)
    i0f = r.integers(0, 16, (n, 3)).astype(np.float32)
    pos = (i0f + r.random((n, 3))).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[::7, 0] = 0.0
    d[1::9, 1] = d[1::9, 2]          # |y| = |z|: the tie goes to y
    d[2::11, 0] = -d[2::11, 1]       # |x| = |y|: the tie goes to x
    want = np.asarray(jmajorant.octant_exit(
        jnp.asarray(rows), jnp.asarray(i0f), jnp.asarray(pos), jnp.asarray(d)))
    got = tmajorant.octant_exit(torch.as_tensor(rows), torch.as_tensor(i0f),
                                torch.as_tensor(pos), torch.as_tensor(d))
    np.testing.assert_array_equal(got.numpy(), want)


TABLE_CASES = {"c5_r16": (lambda p: _c5(16, p), 3),
               "c5_r64": (lambda p: _c5(64, p), 1),
               "cloud64_r32": (_cloud64, None)}


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_host_tables_exact(case, c5):
    """build_majorant_grid's tables and _pack_instance_rows, bit for bit
    the reference's; K as built (3 at R 16, 1 at R 64)."""
    make, k = TABLE_CASES[case]
    js = c5["js"] if case == "c5_r16" else make(False)
    ts = c5["ts"] if case == "c5_r16" else make(True)
    if k is not None:
        assert ts.majorant.cell_instances.shape[1] == k
    for f in dataclasses.fields(ts.majorant):
        np.testing.assert_array_equal(getattr(ts.majorant, f.name).numpy(),
                                      np.asarray(getattr(js.majorant, f.name)),
                                      err_msg=f.name)
    assert ts.majorant.packed.shape[1] == 79  # the octant columns
    for f in ("packed_rows", "inv_xform", "pmin", "pmax", "grid_id"):
        np.testing.assert_array_equal(getattr(ts.instances, f).numpy(),
                                      np.asarray(getattr(js.instances, f)))
    for f in ("root_pmin", "root_pmax", "max_extinction", "min_extinction"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    np.testing.assert_array_equal(ts.atlas.density_corners.numpy(),
                                  np.asarray(js.atlas.density_corners))


def _points(js, n=8192, seed=1):
    """Random points over the root box and just past it, half of them
    near instance centres (cells with several slots), with directions
    that have zero components and major-axis ties."""
    r = np.random.default_rng(seed)
    lo, hi = np.asarray(js.root_pmin), np.asarray(js.root_pmax)
    pos = r.uniform(lo - 0.3, hi + 0.3, (n, 3))
    c = (np.asarray(js.instances.pmin) + np.asarray(js.instances.pmax)) / 2
    pos[: n // 2] = (c[r.integers(0, len(c), n // 2)]
                     + r.normal(scale=1.0, size=(n // 2, 3)))
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::13, 1] = 0.0
    d[3::17, 2] = d[3::17, 0]
    return pos.astype(np.float32), d.astype(np.float32)


def test_cells_banded_fetch_matches_reference(c5):
    """density, s_box and t_box from the cell row and the listed
    instances at random points, through cells with 2 or more valid slots
    and through empty cells whose octant box reaches past the symmetric
    box."""
    js, cs = c5["js"], c5["cs"]
    pos, d = _points(js)
    want = jtracking._cells_banded_fetch(js, jnp.asarray(pos), jnp.asarray(d))
    got = ttracking._cells_banded_fetch(cs, torch.as_tensor(pos),
                                        torch.as_tensor(d))
    for w, g, name in zip(want, got, ("density", "s_box", "t_box")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FETCH_RTOL,
                                   atol=FETCH_ATOL, err_msg=name)
    _, _, _, flat = ttracking._cell_coords(cs, torch.as_tensor(pos))
    slots = (cs.majorant.cell_instances[flat] >= 0).sum(-1)
    density = got[0].numpy()
    assert ((slots >= 2).numpy() & (density > 0)).sum() > 20
    # the same fetch without the octant columns: the symmetric box alone
    m = cs.majorant
    rows = torch.cat([m.cell_rows[:, :7], m.cell_rows[:, 79:]], dim=1)
    bare = dataclasses.replace(cs, majorant=dataclasses.replace(
        m, packed=m.packed[:, :7], cell_rows=rows))
    s_sym = ttracking._cells_banded_fetch(bare, torch.as_tensor(pos),
                                          torch.as_tensor(d))[1].numpy()
    empty = got[2].numpy() <= 0.0
    assert (empty & (got[1].numpy() > s_sym * 1.01)).sum() > 100


def test_folded_taus_match_reference(c5):
    """The port's own world bake folded into the cell rows, and
    cell_tau_fetch on the reference's bake, within TAU_RTOL / TAU_ATOL;
    the rest of the row is unchanged."""
    jb, cb, tb = c5["jb"], c5["cb"], c5["tb"]
    want = np.asarray(jb.majorant.cell_rows)
    got = tb.majorant.cell_rows.numpy()
    assert got.shape == want.shape == (16 ** 3, 79 + 3 + 8)
    np.testing.assert_array_equal(got[:, :82], want[:, :82])
    np.testing.assert_allclose(got[:, 82:], want[:, 82:], rtol=TAU_RTOL,
                               atol=TAU_ATOL)
    assert want[:, 82:].max() > 1.0
    pos, _ = _points(jb, n=4096, seed=3)
    w = np.asarray(jshadow.cell_tau_fetch(jb, jnp.asarray(pos)))
    for scene in (cb, tb):
        g = tshadow.cell_tau_fetch(scene, torch.as_tensor(pos)).numpy()
        np.testing.assert_allclose(g, w, rtol=TAU_RTOL, atol=TAU_ATOL)


def _rays(js, n=1024, seed=0, spread=5.0):
    r = np.random.default_rng(seed)
    lo, hi = np.asarray(js.root_pmin), np.asarray(js.root_pmax)
    o = np.tile(np.asarray(js.camera.origin)[None], (n, 1)).astype(np.float32)
    d = (lo + hi) / 2 + r.uniform(-spread, spread, (n, 3)) - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


FUSED_CASES = [(m, e) for m in ("tracked", "cached") for e in ENVS]


@pytest.mark.parametrize("mode,env", FUSED_CASES,
                         ids=[f"{m}_{e}" for m, e in FUSED_CASES])
def test_fused_direct_ray_by_ray(c5, mode, env):
    """fused_direct_plain's cells branch against the reference's
    fused_direct on the c5 scene at R 16 (K = 3)."""
    js, ts = ((c5["jb"], c5["cb"]) if mode == "cached"
              else (c5["js"], c5["cs"]))
    kw = dict(ray_depth=4, max_fused_steps=256, shadow_mode=mode,
              environment_type=ENVS[env])
    o, d = _rays(js)
    key = jax.random.PRNGKey(3)
    want = [np.asarray(x) for x in
            j_fused(js, JParams(**kw), key, jnp.asarray(o), jnp.asarray(d))]
    got = [x.numpy() for x in t_fused.fused_direct(
        ts, TParams(**kw), tuple(int(k) for k in np.asarray(key)),
        torch.as_tensor(o), torch.as_tensor(d))]
    assert want[2].mean() > 3 and want[1].mean() > 0.05
    share, rel = agreement(got, want, rtol=SKY_RTOL if env == "sky" else 1e-4)
    assert share >= MIN_SHARE, share
    assert rel <= MAX_MEAN_REL, rel
    np.testing.assert_array_equal(got[3], want[3])


def test_c5_instanced_golden():
    """The port renders the c5_instanced golden's scene (the reference's
    tables, R 64) and params and meets tests/test_golden.py::_compare at
    tol_scale 1."""
    ts = _carry(_c5(64))
    kw = dict(BASE_KW, environment_type=int(JEnv.CONSTANT))
    golden = np.load(f"{GOLDEN_DIR}/c5_instanced__fused.npz")["accum"]
    img = TRenderer(ts, TParams(**kw)).render(SPP).accum.numpy()
    assert img.shape == golden.shape and np.isfinite(img).all()
    _compare(img, golden, label="torch c5_instanced")


RAISE_CASES = ["bfloat16_instanced", "octant_instanced"]


@pytest.mark.parametrize("case", RAISE_CASES)
def test_unported_instanced_raise(case):
    """Instanced scenes in bfloat16 rows or with octant columns raise
    NotImplementedError naming ROADMAP A.10, in build_scene and when a
    reference scene is carried over."""
    ids, xforms = common.golden_c5_instances()
    kw = (dict(corner_dtype="bfloat16") if case.startswith("bfloat16")
          else dict(octant_boxes=True))
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        tbuild([_blob(n=8)], instance_grid_ids=ids[:4],
               instance_xforms=xforms[:4], device="cpu", **kw)
    js = jbuild([_blob(n=8)], instance_grid_ids=ids[:4],
                instance_xforms=xforms[:4], **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        _carry(js)


# ---- several grids, the static per-instance loop, emission and color ------

def _two_grids(ext):
    """A 10^3 blob, with emission and color where ``ext``, and an 8^3 one
    with neither (reference HostGrids, voxels of 0.2)."""
    return [_blob(n=10, emission=ext, color=ext), _blob(n=8)]


def _lattice(n_inst, spacing=1.5):
    """n_inst instances alternating over the two grids, ``spacing`` apart
    (their 2-unit boxes overlap), in rows of 4."""
    xforms = []
    for i in range(n_inst):
        xf = np.diag([0.2, 0.2, 0.2, 1.0])
        xf[3, :3] = (spacing * (i % 4), 0.4 * (i % 3), spacing * (i // 4))
        xforms.append(xf)
    return [i % 2 for i in range(n_inst)], xforms


SCENE_CASES = {"loop": (4, False), "loop_ext": (4, True),
               "cells_ext": (12, True)}


def _instanced(case, port=False):
    """SCENE_CASES[case]: 4 instances (the static loop) or 12 (cell lists
    at R 16) of the two grids, one point light, the ramp emission LUT;
    built by the reference (framed as the c5 golden) or by the port."""
    from vpt_tpu_torch.scene.assets import ramp_lut
    n_inst, ext = SCENE_CASES[case]
    ids, xforms = _lattice(n_inst)
    kw = dict(instance_grid_ids=ids, instance_xforms=xforms,
              majorant_resolution=16, emission_lut=ramp_lut())
    lights = ([[3.0, 5.0, 4.0]], [[1.0, 1.0, 1.0]], [40.0])
    if port:
        from vpt_tpu_torch.lights.lights import PointLights as TLights
        return tbuild(_two_grids(ext), device="cpu",
                      lights=TLights.make(*lights, device="cpu"), **kw)
    from vpt_tpu.lights.lights import PointLights as JLights
    return _camera(jbuild(_two_grids(ext), lights=JLights.make(*lights),
                          **kw), dist_scale=0.8)


class _Scenes(dict):
    """{case: (reference scene, its bake, both carried over)}, each case
    built on first use (the bake only where asked)."""

    def __missing__(self, case):
        js = _instanced(case)
        self[case] = [js, None, _carry(js), None]
        return self[case]

    def baked(self, case):
        entry = self[case]
        if entry[1] is None:
            entry[1] = jshadow.attach_shadow_cache(entry[0], **BAKE)
            entry[3] = _carry(entry[1])
        return entry


@pytest.fixture(scope="module")
def inst():
    return _Scenes()


ATLAS_CASES = {"density_only": (False, False, False),
               "emission": (True, False, False),
               "emission_and_color": (True, True, False)}


@pytest.mark.parametrize("case", list(ATLAS_CASES))
def test_multi_grid_atlas_exact(case):
    """build_atlas on three grids (8^3, 10^3 and 6^3) bit for bit the
    reference's: the rows one after another, the emission and color
    columns wherever any grid has them (zeros and white for the others),
    and every grid's offsets (-1 where it lacks a channel)."""
    em, col, _ = ATLAS_CASES[case]
    grids = [_blob(n=8), _blob(n=10, emission=em, color=col),
             _blob(n=6, color=col)]
    want = jgrid.build_atlas(grids)
    got = tgrid.build_atlas(grids, device="cpu")
    for f in ("density", "density_corners", "offset", "emission_offset",
              "color_offset", "dim", "bmin", "max_density", "min_density",
              "voxel_size"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (got.has_emission, got.has_color) == (em, col)
    assert got.density_corners.shape[1] == 15 + 8 * em + 24 * col


@pytest.mark.parametrize("case", list(SCENE_CASES))
def test_instanced_tables_exact(case, inst):
    """build_scene's instance rows, root box, extinction bounds and
    majorant tables bit for bit the reference's: at 4 instances the
    packed rows with the 72 octant columns and no lists; at 12 the cell
    lists, each emissive instance listed in its whole box."""
    js, ts = inst[case][0], _instanced(case, port=True)
    n_inst = SCENE_CASES[case][0]
    for f in dataclasses.fields(ts.majorant):
        got, want = getattr(ts.majorant, f.name), getattr(js.majorant, f.name)
        assert (got is None) == (want is None) == (
            n_inst <= 8 and f.name in ("cell_instances", "cell_rows"))
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f.name)
    assert ts.majorant.packed.shape[1] == 79
    for f in ("packed_rows", "inv_xform", "pmin", "pmax", "grid_id"):
        np.testing.assert_array_equal(getattr(ts.instances, f).numpy(),
                                      np.asarray(getattr(js.instances, f)))
    for f in ("root_pmin", "root_pmax", "max_extinction", "min_extinction"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    np.testing.assert_array_equal(ts.atlas.density_corners.numpy(),
                                  np.asarray(js.atlas.density_corners))


FETCH_CASES = [(c, f) for c in ("loop_ext", "cells_ext")
               for f in ("density", "emission", "color")]


@pytest.mark.parametrize("case,what", FETCH_CASES,
                         ids=[f"{c}_{f}" for c, f in FETCH_CASES])
def test_scene_fetches_exact(case, what, inst):
    """scene_density, scene_emission and scene_color at 4096 seeded points
    equal the reference's, over every instance in order (the loop) or over
    the cell's list; Cd is white wherever an instance of the grid without
    color is in play, in and out of its box (the reference's quirk),
    which in the loop is everywhere."""
    js, _, cs, _ = inst[case]
    pos, _ = _points(js, n=4096, seed=5)
    jp, tp = JParams(emission_scale=2.0), TParams(emission_scale=2.0)
    fn = {"density": (lambda: jtracking.scene_density(js, jnp.asarray(pos)),
                      lambda: ttracking.scene_density(cs, torch.as_tensor(
                          pos))),
          "emission": (lambda: jtracking.scene_emission(js, jnp.asarray(pos),
                                                        jp),
                       lambda: ttracking.scene_emission(
                           cs, torch.as_tensor(pos), tp)),
          "color": (lambda: jtracking.scene_color(js, jnp.asarray(pos)),
                    lambda: ttracking.scene_color(cs, torch.as_tensor(pos)))}
    want, got = np.asarray(fn[what][0]()), fn[what][1]().numpy()
    np.testing.assert_array_equal(got, want)
    assert (want != 0).mean() > 0.01
    if what == "color":
        white = np.all(got == 1.0, axis=-1)
        assert white.all() if case == "loop_ext" else 0.05 < white.mean() < 1


WORLD_TAU_TOL = 1e-6   # rtol and atol: float32 sums taken in other orders


def test_world_tau_grid_and_fetch(inst):
    """The port's world bake of a 4-instance scene (no lists) into the
    world tau grid within WORLD_TAU_TOL of the reference's, and
    world_tau_fetch exact on the reference's grid; the grid round-trips
    through scene_to_arrays."""
    from vpt_tpu_torch.scene.convert import scene_to_arrays
    js, jb, cs, cb = inst.baked("loop")
    want = np.asarray(jb.world_tau)
    tb = tshadow.attach_shadow_cache(cs, **BAKE)
    assert tb.majorant.cell_rows is None and want.shape[-1] == 16
    np.testing.assert_allclose(tb.world_tau.numpy(), want,
                               rtol=WORLD_TAU_TOL, atol=WORLD_TAU_TOL)
    assert want.max() > 0.5
    pos, _ = _points(jb, n=4096, seed=7)
    np.testing.assert_array_equal(
        tshadow.world_tau_fetch(cb, torch.as_tensor(pos)).numpy(),
        np.asarray(jshadow.world_tau_fetch(jb, jnp.asarray(pos))))
    back = scene_from_arrays(scene_to_arrays(cb), device="cpu")
    assert torch.equal(back.world_tau, cb.world_tau)
    assert back.majorant.cell_rows is None


@pytest.mark.parametrize("query", ["local_majorant_query", "empty_skip_t"])
def test_packed_majorant_queries_exact(inst, query):
    """The loop's bound and box exit from the packed rows (with the octant
    columns) at 8192 random points and directions equal the reference's
    local_majorant_query and empty_skip_t."""
    js, _, cs, _ = inst["loop"]
    pos, d = _points(js)
    want = getattr(jmajorant, query)(js.majorant, js.root_pmin, js.root_pmax,
                                     jnp.asarray(pos), jnp.asarray(d))
    got = getattr(tmajorant, query)(cs.majorant, cs.root_pmin, cs.root_pmax,
                                    torch.as_tensor(pos), torch.as_tensor(d))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[1]) > 0).mean() > 0.3


LOOP_FUSED = [("loop", "tracked", 1), ("loop", "cached", 1),
              ("loop_ext", "cached", 1), ("cells_ext", "tracked", 1),
              ("cells_ext", "cached", 2)]


@pytest.mark.parametrize("case,mode,vd", LOOP_FUSED,
                         ids=[f"{c}_{m}_vd{v}" for c, m, v in LOOP_FUSED])
def test_instanced_fused_ray_by_ray(inst, case, mode, vd):
    """fused_direct_plain on the static loop (the world tau grid in cached
    mode), with emission and color on the loop (cached) and on cell lists
    (tracked, and cached at volume_depth 2), against the reference's
    fused_direct ray by ray, CONSTANT, emission_scale 2
    (test_fused_direct_ray_by_ray's rule)."""
    js, jb, cs, cb = inst.baked(case) if mode == "cached" else inst[case]
    js, ts = (jb, cb) if mode == "cached" else (js, cs)
    kw = dict(ray_depth=4, max_fused_steps=256, shadow_mode=mode,
              environment_type=int(JEnv.CONSTANT), emission_scale=2.0,
              volume_depth=vd)
    o, d = _rays(js, n=512, spread=2.0)
    key = jax.random.PRNGKey(3)
    want = [np.asarray(x) for x in
            j_fused(js, JParams(**kw), key, jnp.asarray(o), jnp.asarray(d))]
    got = [x.numpy() for x in t_fused.fused_direct(
        ts, TParams(**kw), tuple(int(k) for k in np.asarray(key)),
        torch.as_tensor(o), torch.as_tensor(d))]
    assert want[2].mean() > 1.5
    share, rel = agreement(got, want)
    assert share >= MIN_SHARE, share
    assert rel <= MAX_MEAN_REL, rel
    np.testing.assert_array_equal(got[3], want[3])


LIGHTS = np.array([[0.0, 12.0, 12.0, 1.0, 0.9, 0.8, 200.0],
                   [6.0, 2.0, -9.0, 0.3, 0.5, 1.0, 120.0]])


def test_ins_files_read_and_write_alike(tmp_path):
    """Each package reads what the other writes, both variants; and
    instance_transform equals the reference's exactly."""
    vols = tins.InsFile(volumes=[tins.InsVolumeFile(
        "a.vdb", np.array([[1, 2, 3, 0, 0, 0.38268343, 0.9238795, 1.5],
                           [-4, 0.5, 2, 0.1, 0.2, 0.3, 0.9, 0.75]])),
        tins.InsVolumeFile("sub/b.vdb", np.zeros((0, 8)))])
    for name, ins in (("l.ins", tins.InsFile(lights=LIGHTS)),
                      ("v.ins", vols)):
        tins.write_ins(str(tmp_path / f"t_{name}"), ins)
        jins.write_ins(str(tmp_path / f"j_{name}"), jins.InsFile(
            lights=ins.lights, volumes=[jins.InsVolumeFile(
                v.vdb_file, v.instances) for v in ins.volumes]))
        assert (tmp_path / f"t_{name}").read_text() == \
            (tmp_path / f"j_{name}").read_text()
        got = tins.read_ins(str(tmp_path / f"j_{name}"))
        want = jins.read_ins(str(tmp_path / f"t_{name}"))
        if want.lights is not None:
            np.testing.assert_array_equal(got.lights, want.lights)
        assert [v.vdb_file for v in got.volumes] == \
            [v.vdb_file for v in want.volumes]
        for a, b in zip(got.volumes, want.volumes):
            np.testing.assert_array_equal(a.instances, b.instances)
    r = np.random.default_rng(4)
    for i in range(300):
        q = r.normal(size=4) * r.choice([1e-3, 1.0, 10.0])
        if i % 50 == 0:
            q[:] = 0.0
        g = np.diag(np.r_[r.uniform(0.05, 2.0, 3), 1.0])
        g[3, :3], g[0, 1] = r.normal(size=3), r.normal()
        p, s = r.normal(size=3), r.uniform(0.1, 3.0)
        np.testing.assert_array_equal(tins.instance_transform(g, p, q, s),
                                      jins.instance_transform(g, p, q, s))


def test_cli_renders_ins_lights_variant(tmp_path):
    """`vpt-torch render x.ins` on a lights file renders its point lights
    over the procedural volume: ray for ray `vpt render procedural` with
    the same --light flags (the reference's own `render x.ins` passes
    `lights` to build_scene twice and raises TypeError), on a 16^3 grid
    in place of the 200^3 one in both packages."""
    ins = tmp_path / "lights.ins"
    tins.write_ins(str(ins), tins.InsFile(lights=LIGHTS))
    grid = tproc.create_procedural_grid(vmin=(-8.0,) * 3, vmax=(8.0,) * 3,
                                        scale=0.08, device="cpu")
    common_args = ["--width", "32", "--height", "32", "--ray-depth", "3",
                   "--spp", "2", "--env-type", "black", "--save-exr",
                   "--cpu"]
    flags = [f for row in LIGHTS for f in ["--light", *map(str, row)]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jproc, "default_procedural_grid", lambda *a, **k: grid)
        mp.setattr(tproc, "default_procedural_grid", lambda *a, **k: grid)
        tcli.main(["render", str(ins), "-o", str(tmp_path / "t.png")]
                  + common_args)
        jcli.main(["render", "procedural", "-o", str(tmp_path / "j.png")]
                  + common_args + flags)
        with pytest.raises(TypeError, match="lights"):
            jins.load_ins_scene(str(ins), lights=None)
    got, want = (read_exr_rgb(str(tmp_path / f"{w}.exr")) for w in "tj")
    assert got.shape == (32, 32, 3) and want.mean() > 0
    assert radiance_share(got, want) >= MIN_SHARE


@pytest.mark.parametrize("extra", [[], ["--union", "auto"]],
                         ids=["volumes_variant", "union"])
def test_cli_ins_exits_naming_the_vdb_reader(tmp_path, extra):
    """The volumes variant (and --union, which collapses it) exit before
    any work, naming the .vdb reader's ROADMAP item."""
    ins = tmp_path / "cloud.ins"
    if extra:
        tins.write_ins(str(ins), tins.InsFile(lights=LIGHTS))
    else:
        tins.write_ins(str(ins), tins.InsFile(volumes=[tins.InsVolumeFile(
            "cloud.vdb", np.array([[0, 0, 0, 0, 0, 0, 1, 1.0]]))]))
    with pytest.raises(SystemExit) as e:
        tcli.main(["render", str(ins), "-o", str(tmp_path / "x.png"),
                   "--cpu", *extra])
    assert "the .vdb reader" in str(e.value)


def test_cached_without_bake_raises(c5):
    """shadow_mode="cached" on an instanced scene whose cell rows carry
    no taus raises ValueError, as on a single instance (the reference
    renders tracked shadows there)."""
    o, d = (torch.as_tensor(a) for a in _rays(c5["js"], n=8))
    with pytest.raises(ValueError, match="attach_shadow_cache"):
        t_fused.fused_direct(c5["cs"], TParams(shadow_mode="cached"), (0, 1),
                             o, d)
