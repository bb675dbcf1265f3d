"""The majorant cell grid of instanced scenes (port of
vpt_tpu/accel/majorant.py:23-232): the flat replacement for the
reference's octree over volume instances.

``build_majorant_grid`` runs on the host in numpy and scipy, as the
reference's does, except the octant box growth, which runs in torch on
the scene's device (volume/grid.py::_octant_box_extents).  Each instance's
nonzero voxels are splatted into R^3 world cells with a max, dilated by
the trilinear reach, banded into [T_box, box extents 6], given the 72
octant columns, and listed per cell (ids -1-padded to the largest overlap
K).  ``cell_rows`` = [T_box, ext 6, octant 72, ids K] is what a walk step
reads (render/tracking.py::_cells_banded_fetch); the shadow cache of an
instanced scene appends its tau columns to it (accel/shadow.py).

Below ``instance_list_threshold`` instances no lists are built: the
static per-instance loop reads the packed rows alone
(``local_majorant_query``), [T_box, ext 6] and the 72 octant columns
where ``octant_cells`` "auto" turns them on (R <= 128, more than one
instance).

``octant_exit`` is the walk's exit from the anchored box of the ray's
octant and major axis.  The reference selects the box with a tree of
``where``s; here the column is indexed, which reads the same 3 floats.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vpt_tpu_torch.core.device import DEFAULT_DEVICE
from vpt_tpu_torch.utils.logger import VPT_WARNING, log
from vpt_tpu_torch.volume.grid import (BAND_DIVISORS, _empty_box_extents,
                                       _octant_box_extents)

K_MAX = 600  # the reference's per-node cap, OCTNode.vol_indices[600]


def _dilate_max(grid: np.ndarray, r: int) -> np.ndarray:
    """Grey dilation by a cube of radius r; np.roll wraps around the
    boundary, which can only raise a majorant (safe)."""
    out = grid.copy()
    for axis in (0, 1, 2):
        acc = out.copy()
        for s in range(1, r + 1):
            acc = np.maximum(acc, np.roll(out, s, axis=axis))
            acc = np.maximum(acc, np.roll(out, -s, axis=axis))
        out = acc
    return out


def _build_cell_lists(inst_cells, n_instances: int, R: int,
                      pad_cells: int = 1, k_max: int = K_MAX) -> np.ndarray:
    """(R^3, K) int32 per-cell instance ids, -1-padded to the largest
    overlap K (capped at k_max).  ``inst_cells[i]``: the flat cells that
    instance i's nonzero voxels splat into, each set dilated by
    ``pad_cells`` (L-inf, clipped to the grid) so trilinear spill stays
    covered; ids go into each cell in instance order."""
    r = pad_cells
    dz, dy, dx = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1),
                             np.arange(-r, r + 1), indexing="ij")
    dz, dy, dx = dz.reshape(-1), dy.reshape(-1), dx.reshape(-1)
    dilated = []
    for i in range(n_instances):
        cells = inst_cells.get(i)
        if cells is None or len(cells) == 0:
            dilated.append(np.zeros(0, np.int64))
            continue
        cz, rem = np.divmod(cells, R * R)
        cy, cx = np.divmod(rem, R)
        zz = np.clip(cz[:, None] + dz[None, :], 0, R - 1)
        yy = np.clip(cy[:, None] + dy[None, :], 0, R - 1)
        xx = np.clip(cx[:, None] + dx[None, :], 0, R - 1)
        dilated.append(np.unique((zz * R + yy) * R + xx))

    counts = np.zeros(R * R * R, np.int32)
    for cells in dilated:
        counts[cells] += 1
    K = int(min(max(counts.max(), 1), k_max))
    if counts.max() > k_max:
        log(f"cell instance overlap {counts.max()} exceeds cap {k_max}; "
            "densities under-counted in hot cells", VPT_WARNING)
    table = np.full((R * R * R, K), -1, np.int32)
    fill = np.zeros(R * R * R, np.int32)
    for i, cells in enumerate(dilated):
        f = fill[cells]
        ok = f < K
        table[cells[ok], f[ok]] = i
        fill[cells] = f + ok
    return table


def _box_cells(g, xf, root_pmin, cell, R: int) -> np.ndarray:
    """The flat cells of instance box [bbox_min, bbox_min + dim] in world
    space: a grid with emission or color is listed in its whole box, where
    its emission and color are read even at zero density
    (vpt_tpu/accel/majorant.py:124-144)."""
    bmin = np.asarray(g.bbox_min, np.float64)
    corners = np.array([[x, y, z] for x in (bmin[0], bmin[0] + g.dim[0])
                        for y in (bmin[1], bmin[1] + g.dim[1])
                        for z in (bmin[2], bmin[2] + g.dim[2])])
    wc = corners @ xf[:3, :3] + xf[3, :3]
    lo = np.clip(np.floor((wc.min(0) - root_pmin) / cell).astype(np.int64),
                 0, R - 1)
    hi = np.clip(np.floor((wc.max(0) - root_pmin) / cell).astype(np.int64),
                 0, R - 1)
    gz, gy, gx = np.meshgrid(np.arange(lo[2], hi[2] + 1),
                             np.arange(lo[1], hi[1] + 1),
                             np.arange(lo[0], hi[0] + 1), indexing="ij")
    return np.unique((gz.ravel() * R + gy.ravel()) * R + gx.ravel())


def build_majorant_grid(host_grids, instance_grid_ids, xforms, root_pmin,
                        root_pmax, resolution: int,
                        build_instance_lists: bool = False,
                        octant_cells: bool | str = "auto",
                        device=DEFAULT_DEVICE, timings: dict | None = None):
    """MajorantGrid on ``device`` (scene/scene.py), every table equal to
    the reference's.  ``timings``, where given, receives the seconds of
    the stages: ``splat`` (splat, dilation, chebyshev distance and the
    banded boxes), ``octant`` (the octant columns) and ``cell_lists``."""
    from scipy import ndimage

    from vpt_tpu_torch.scene.scene import MajorantGrid

    t0 = time.perf_counter()
    R = int(resolution)
    root_pmin = np.asarray(root_pmin, np.float64)
    root_pmax = np.asarray(root_pmax, np.float64)
    cell = (root_pmax - root_pmin) / R
    grid_max = np.zeros((R, R, R), np.float32)  # [z, y, x]
    max_influence = 0.0
    inst_cells: dict[int, np.ndarray] = {}
    for inst_i, (gid, xf) in enumerate(zip(instance_grid_ids, xforms)):
        g = host_grids[int(gid)]
        d = g.density_zyx
        zz, yy, xx = np.nonzero(d > 0)
        if len(zz) == 0:
            continue
        vals = d[zz, yy, xx]
        # voxel i's centre sits at index position bmin + i + 0.5
        ipos = np.stack([xx, yy, zz], axis=-1).astype(np.float64)
        ipos += g.bbox_min + 0.5
        wpos = ipos @ xf[:3, :3] + xf[3, :3]
        ci = np.clip(np.floor((wpos - root_pmin) / cell).astype(np.int64),
                     0, R - 1)
        flat = (ci[:, 2] * R + ci[:, 1]) * R + ci[:, 0]
        np.maximum.at(grid_max.reshape(-1), flat, vals)
        if build_instance_lists:
            inst_cells[inst_i] = (
                _box_cells(g, xf, root_pmin, cell, R)
                if g.emission_zyx is not None or g.color_zyx is not None
                else np.unique(flat))
        # trilinear reach: +-1 voxel in index space, in world units
        voxel_world = np.linalg.norm(xf[:3, :3], axis=1).max()
        max_influence = max(max_influence, 1.5 * voxel_world)

    r_cells = int(np.ceil(max_influence / cell.min())) if max_influence else 0
    r_cells = min(max(r_cells, 1), 3)
    grid_max = _dilate_max(grid_max, r_cells)
    occ = grid_max > 0.0
    skip = ndimage.distance_transform_cdt(
        ~occ, metric="chessboard").astype(np.int32)

    gmax = float(grid_max.max()) if grid_max.size else 0.0
    bands = [gmax * f for f in BAND_DIVISORS]
    band_idx = np.zeros(grid_max.shape, np.int8)
    for b, t in enumerate(bands):
        band_idx[grid_max > t] = min(b + 1, len(bands) - 1)
    t_box = np.zeros(grid_max.shape, np.float32)
    ext = np.zeros((6,) + grid_max.shape, np.float32)
    for b, t in enumerate(bands):
        sel = band_idx == b
        if not sel.any():
            continue
        eb = _empty_box_extents(grid_max > t, where=sel, device=device)
        ext[:, sel] = eb[:, sel]
        t_box[sel] = t
    packed = np.ascontiguousarray(np.concatenate(
        [t_box.reshape(-1, 1), ext.reshape(6, -1).T], axis=-1))
    t1 = time.perf_counter()
    if octant_cells == "auto":
        octant_cells = R <= 128 and len(instance_grid_ids) > 1
    if octant_cells:
        oct_ext = _octant_box_extents(occ, device=device)
        packed = np.ascontiguousarray(np.concatenate(
            [packed, oct_ext.reshape(oct_ext.shape[0], -1).T], axis=-1))
    t2 = time.perf_counter()
    f32 = dict(dtype=torch.float32, device=device)
    cell_instances = cell_rows = None
    if build_instance_lists:
        table = _build_cell_lists(inst_cells, len(instance_grid_ids), R,
                                  pad_cells=max(r_cells, 1))
        assert len(instance_grid_ids) < (1 << 24)  # ids exact in float32
        cell_instances = torch.as_tensor(table, device=device)
        cell_rows = torch.as_tensor(np.ascontiguousarray(np.concatenate(
            [packed.astype(np.float32), table.astype(np.float32)], axis=1)),
            **f32)
    t3 = time.perf_counter()
    if timings is not None:
        timings.update(splat=t1 - t0, octant=t2 - t1, cell_lists=t3 - t2)
    return MajorantGrid(
        max_density=torch.as_tensor(grid_max, **f32),
        occupied=torch.as_tensor(occ, device=device),
        skip_dist=torch.as_tensor(skip, device=device),
        packed=torch.as_tensor(packed, **f32),
        cell_instances=cell_instances,
        cell_rows=cell_rows)


def octant_exit(oct_rows, i0f, pos_u, dvec):
    """Exit distance of the anchored empty box of the ray's octant and
    major axis (the 72 octant columns, (..., 72)).  ``i0f``: the floor
    cell coordinate; ``pos_u``: the position in cell units; ``dvec``: the
    direction in cell units per world unit.  The octant is dvec > 0 per
    axis; the major axis the largest |dvec|, a tie going to the lower
    axis; a component below 1e-12 never reaches its face (t = 3.4e38).
    Valid only on guaranteed-empty cells."""
    pos_dir = dvec > 0.0
    adir = torch.abs(dvec)
    octant = (pos_dir[..., 0].to(torch.int64)
              + 2 * pos_dir[..., 1].to(torch.int64)
              + 4 * pos_dir[..., 2].to(torch.int64))
    m01 = (adir[..., 1] > adir[..., 0]).to(torch.int64)
    m01_mag = torch.maximum(adir[..., 0], adir[..., 1])
    major = torch.where(adir[..., 2] > m01_mag, 2, m01)
    col = (9 * octant + 3 * major)[..., None] + torch.arange(
        3, device=dvec.device)
    e3 = torch.clamp(torch.gather(oct_rows, -1, col), min=0.0)
    face = torch.where(pos_dir, i0f + 1.0 + e3, i0f - e3)
    tiny = torch.abs(dvec) < 1e-12
    safe = torch.where(tiny, 1e-12, dvec)
    t_ax = torch.where(tiny, 3.4e38, (face - pos_u) / safe)
    return torch.amin(t_ax, dim=-1)


def _packed_box(major, root_pmin, root_pmax, pos, direction):
    """(packed row, empty-box exit distance before the clamp at 0) of the
    cell at world ``pos``: the box's, widened on an empty cell by the
    octant box's where the rows carry the octant columns."""
    from vpt_tpu_torch.core.vecmath import _amin3, true_div
    R = major.resolution
    cs = true_div(root_pmax - root_pmin, R)
    rel = (pos - root_pmin) / cs
    ci = torch.clamp(torch.floor(rel).to(torch.int64), 0, R - 1)
    row = major.packed[(ci[..., 2] * R + ci[..., 1]) * R + ci[..., 0]]
    cif = ci.to(torch.float32)
    cube_min = root_pmin + (cif - torch.clamp(row[..., 1:4], min=0.0)) * cs
    cube_max = root_pmin + (cif + 1.0 + torch.clamp(row[..., 4:7], min=0.0)) \
        * cs
    inv = 1.0 / torch.where(torch.abs(direction) < 1e-12, 1e-12, direction)
    t_exit = _amin3(torch.maximum((cube_min - pos) * inv,
                                  (cube_max - pos) * inv))
    if row.shape[-1] >= 79:
        t_oct = octant_exit(row[..., 7:79], cif, rel, direction / cs)
        t_exit = torch.where(row[..., 0] <= 0.0,
                             torch.maximum(t_exit, t_oct), t_exit)
    return row, t_exit


def local_majorant_query(major, root_pmin, root_pmax, pos, direction):
    """(sigma_cell, dt_exit) at world ``pos`` from the packed rows: the
    cell's banded bound T_box (0 = empty) and the distance to the exit of
    its box (vpt_tpu/accel/majorant.py:284-322)."""
    row, t_exit = _packed_box(major, root_pmin, root_pmax, pos, direction)
    return row[..., 0], torch.clamp(t_exit, min=0.0)


def empty_skip_t(major, root_pmin, root_pmax, pos, direction):
    """(empty, t_exit): whether the cell at ``pos`` is guaranteed empty
    (T_box 0) and the distance to its box's exit
    (vpt_tpu/accel/majorant.py:325-354)."""
    row, t_exit = _packed_box(major, root_pmin, root_pmax, pos, direction)
    return row[..., 0] <= 0.0, torch.clamp(t_exit, min=0.0)
