"""K5's per-tile key table (render/walk.py::key_table_plain, the layout of
csrc/walk.cu's slot_key) against the keys vpt_tpu's integrators derive
with jax.random.fold_in / split, and the host side of K5's launch: the
tile count and the device buffers' sizes.

Every key is an exact pair of uint32 words, so each comparison is exact.
No jitted loop runs: each reference key is a handful of eager fold_in /
split calls, following the integrators line by line (cited at each).
"""

import ctypes
import os
import re

import jax
import numpy as np
import pytest

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.render import walk

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "vpt_tpu_torch", "csrc")


def fold(k, n):
    return jax.random.fold_in(k, n)


def split(k, n=2):
    return jax.random.split(k, n)


def words(k):
    return tuple(int(v) for v in np.asarray(k, dtype=np.uint32))


def hg_keys(k, two_lobes):
    """core/phase.py::phase_sample's draw keys on k (:47, :64, :87)."""
    if two_lobes:
        k1, k2 = split(k)
        return [words(x) for x in (*split(k1), *split(k2))]
    return [words(x) for x in split(k)]


def vol_reference(kd, n_pt, two_lobes):
    """{slot: key} of vpt_tpu/render/vol_integrator.py's bounce key kd."""
    kl = fold(kd, 1)                                # vol_integrator.py:71
    ks = fold(kl, 3)                                # :40
    k_light, k_phase, k_tr1, k_tr2 = split(ks, 4)   # nee.py:130
    ref = {walk.V_WALK: words(fold(kd, 0)),          # vol_integrator.py:58
           walk.V_PICK: words(fold(kl, 0)),          # :29
           walk.V_SUN: words(fold(fold(kl, 1), 0)),  # :33, nee.py:60
           walk.V_SKY_TR: words(k_tr1), walk.V_SKY_TR + 1: words(k_tr2),
           walk.V_EMIT: words(fold(kd, 2))}          # vol_integrator.py:74
    for i, k in enumerate(split(k_light)):          # nee.py:110
        ref[walk.V_SKY_U + i] = words(k)
    for i, k in enumerate(hg_keys(k_phase, two_lobes)):
        ref[walk.V_SKY_HG + i] = k
    for i, k in enumerate(hg_keys(fold(kd, 3), two_lobes)):  # :77
        ref[walk.V_SCATTER_HG + i] = k
    for w in range(n_pt):
        kw = fold(fold(kl, 2), w)                   # :37, nee.py:77
        ref[walk.V_POINT + 2 * w] = words(fold(kw, 0))      # nee.py:78
        ref[walk.V_POINT + 2 * w + 1] = words(fold(kw, 1))  # nee.py:84
    return ref


def direct_reference(kd, n_pt, nv, two_lobes):
    """{slot: key} of vpt_tpu/render/integrator.py's bounce key kd."""
    ref, d = {}, 5 * nv
    for v in range(nv):
        kv = fold(kd, 100 + v)                      # integrator.py:121
        ref[v] = words(kv)
        for i, k in enumerate(hg_keys(fold(kv, 1), two_lobes)):  # :133
            ref[nv + 4 * v + i] = k
    ref[d + walk.D_SUN] = words(fold(fold(kd, 2), 0))  # :144, nee.py:60
    ref[d + walk.D_EMIT] = words(fold(kd, 4))          # :152
    ref[d + walk.D_SPH] = words(fold(kd, 5))           # :164
    ref[d + walk.D_SPH_TR] = words(fold(fold(kd, 5), 3))  # :91
    for w in range(n_pt):
        kw = fold(fold(kd, 3), w)                   # :149, nee.py:77
        ref[d + walk.D_POINT + 2 * w] = words(fold(kw, 0))
        ref[d + walk.D_POINT + 2 * w + 1] = words(fold(kw, 1))
    return ref


def check_table(layout, ref_fn, tile, tiles=(0, 2), d0=1, depths=2,
                steps=(0, 1, 5)):
    key = rng.render_key(9, 3)
    table = walk.key_table_plain(layout, key, 3, tile, d0, depths)
    jkey = fold(jax.random.PRNGKey(9), 3)
    assert words(jkey) == key
    for t in tiles:
        kt = fold(jkey, 1000 + t) if tile > 0 else jkey  # renderer.py:279
        for i in range(depths):
            kd = fold(kt, d0 + i)        # vol_integrator.py:56, :111
            ref = ref_fn(kd)
            got = table[t, i]
            for slot in range(layout.scalars):
                if slot in ref:
                    assert tuple(got[slot].tolist()) == ref[slot], slot
            for j, ws in enumerate(layout.walks):
                wk = jax.random.wrap_key_data(np.asarray(ref[ws], np.uint32),
                                              impl="threefry2x32")
                for s in steps:          # tracking.py:600, :668, :723
                    want = words(jax.random.key_data(fold(wk, s)))
                    a = layout.scalars + j * layout.steps + s
                    assert tuple(got[a].tolist()) == want, (j, s)


@pytest.mark.parametrize("two_lobes", [False, True])
def test_volumetric_slab_matches_the_reference_chains(two_lobes):
    layout = walk.key_layout(True, 2, 1, True, False, two_lobes, 6)
    assert layout.scalars == walk.V_POINT + 4 and len(layout.walks) == 7
    check_table(layout, lambda kd: vol_reference(kd, 2, two_lobes), 128)


@pytest.mark.parametrize("nv,sphere,two_lobes", [(1, False, False),
                                                 (2, True, True)])
def test_direct_slab_matches_the_reference_chains(nv, sphere, two_lobes):
    layout = walk.key_layout(False, 1, nv, True, sphere, two_lobes, 6)
    assert len(layout.walks) == nv + 1 + 1 + 1 + sphere
    check_table(layout, lambda kd: direct_reference(kd, 1, nv, two_lobes),
                64)


def test_tile_zero_is_one_tile_under_the_key_itself():
    layout = walk.key_layout(True, 1, 1, False, False, False, 3)
    check_table(layout, lambda kd: vol_reference(kd, 1, False), 0,
                tiles=(0,), d0=0, depths=1, steps=(0, 2))


def test_layout_constants_match_walk_cu():
    """The Python layout's slots and the buffers' shapes are csrc/walk.cu's
    (its device code in csrc/walk.cuh; the kernel also checks key_scalars
    and key_walks at each launch)."""
    src = "".join(open(os.path.join(CSRC, f)).read()
                  for f in ("walk.cu", "walk.cuh"))

    def consts(names):
        return [int(re.search(rf"\b{n} = (\d+)", src).group(1))
                for n in names]

    assert consts(["V_WALK", "V_PICK", "V_SUN", "V_SKY_TR", "V_EMIT",
                   "V_SKY_U", "V_SKY_HG", "V_SCATTER_HG", "V_POINT"]) == [
        walk.V_WALK, walk.V_PICK, walk.V_SUN, walk.V_SKY_TR, walk.V_EMIT,
        walk.V_SKY_U, walk.V_SKY_HG, walk.V_SCATTER_HG, walk.V_POINT]
    assert consts(["D_SUN", "D_EMIT", "D_SPH", "D_SPH_TR", "D_POINT"]) == [
        walk.D_SUN, walk.D_EMIT, walk.D_SPH, walk.D_SPH_TR, walk.D_POINT]
    assert consts(["N_QUEUES", "N_COUNTS", "N_STATS", "N_STATS_STAGES"]) == [
        walk.N_QUEUES, walk.N_COUNTS, walk.N_STATS, walk.N_STATS_STAGES]
    assert consts(["L_KEYS", "L_DIRECT", "L_EXTEND", "L_NEE", "L_SCATTER",
                   "N_LAUNCH_KINDS"]) == list(range(len(walk.STAGES) + 1))
    m = re.search(r"struct __align__\(16\) PathState \{(.*?)\};", src, re.S)
    assert m and sum(int(n) if n else 1 for n in re.findall(
        r"\w+(?:\[(\d+)\])?[,;]", m.group(1))) == walk.PATH_FLOATS


def test_n_tiles():
    assert walk.n_tiles(2_073_600, 16384) == 127
    assert walk.n_tiles(16384, 16384) == 1
    assert walk.n_tiles(16385, 16384) == 2
    assert walk.n_tiles(1073, 2000) == 1
    assert walk.n_tiles(1073, 0) == 1


@pytest.mark.parametrize("volumetric", [False, True])
def test_work_buffers_are_sized_and_reused(volumetric):
    """_work's buffers for B rays: the key table (2 words a key), the
    counters (N_COUNTS a bounce and one more), and for walk_volumetric
    the path states and queues; kept while (B, tile) stays."""
    layout = walk.key_layout(volumetric, 1, 1, False, False, False, 256)
    p = walk._WalkParams()
    p.ray_depth, p.key_steps = 50, layout.steps
    p.key_scalars, p.key_walks = layout.scalars, len(layout.walks)
    p.key_depths = 1 if volumetric else walk.DIRECT_KEY_DEPTHS
    launch = walk.WalkLaunch(volumetric, False, p, None, None, ())
    for B, tile in ((2_073_600, 16384), (1000, 400)):
        p.B, p.tile, p.n_tiles = B, tile, walk.n_tiles(B, tile)
        w = walk._work(launch, p, "cpu")
        keys, counts = launch.work[3][:2]
        assert keys.numel() == 2 * p.n_tiles * p.key_depths * layout.slab
        assert counts.numel() == walk.N_COUNTS * 51
        assert (w.state is not None) == volumetric
        if volumetric:
            state, queue = launch.work[3][2:]
            assert state.numel() == walk.PATH_FLOATS * B
            assert queue.numel() == walk.N_QUEUES * B
        assert walk._work(launch, p, "cpu") is w
    assert ctypes.sizeof(walk._WalkWork) == 4 * ctypes.sizeof(
        ctypes.c_void_p)


def test_1080p_volumetric_slab_fits_l2():
    """A bounce's table at 1080p with one point light and emission: 127
    slabs of 16 + 2 scalars and 6 walks of 256 step keys, 1.58 MB."""
    layout = walk.key_layout(True, 1, 1, True, False, False, 256)
    assert layout.slab == 18 + 6 * 256
    assert 127 * layout.slab * 8 == 1_578_864
