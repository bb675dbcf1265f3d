"""The per-step fetches and their helpers, and the reference engine's
walks (port of vpt_tpu/render/tracking.py).

The walks (:575-740): ``delta_track`` (free-path sampling at the global
majorant, jumping guaranteed-empty boxes through ``unified_fetch``),
``transmittance`` (residual ratio tracking) and ``estimate_emission``
(the rate-weighted emission line integral), lane-masked loops that draw
as the reference does; kernel K5 (csrc/walk.cu) runs them per ray.

Single-instance scenes: one corner-row load (float32 or bfloat16 rows,
read as float32) serves the trilinear density, the banded bound T_box
with its box-exit distance (on an empty box widened by the octant box's
where the rows carry the octant columns), the emission and color
channels, and the cached shadow taus (``_unified_fetch_single``; K1's
``fetch_row``).  Instanced scenes with cell lists: one majorant
cell row serves T_box, the box and octant exits, the cell's instance ids
and the cached taus, and each listed instance adds its trilinear density
from one instance row and one corner row (``_cells_banded_fetch``; K1's
CELLS variant).  Instanced scenes without lists: the static loop over
every instance in order (``scene_density``) and the majorant grid's
packed row (``_loop_banded_fetch``; K1's CELLS instances with LOOP).
Emission sums and color takes the component-wise max over the listed
instances, or over all of them in the loop (``scene_emission``,
``scene_color``), each read from the instance's unified corner row.  The
reference's ``optimization_barrier``s steer XLA's
TPU scheduling and have no counterpart here; its one-hot matmuls (the
LUTs, the instance rows of a cell) are indexed loads, exact alike on
finite rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.vecmath import (EPS, _amax3, _amin3, aabb_contains,
                                        aabb_intersect, transform_point,
                                        true_div)
from vpt_tpu_torch.scene.geometry import _sphere_roots
from vpt_tpu_torch.volume.grid import unified_layout


class FetchResult(NamedTuple):
    """What one corner-row load carries (None when absent)."""

    density: torch.Tensor
    s_box: torch.Tensor
    t_box: torch.Tensor
    tau: Optional[torch.Tensor] = None   # (..., 1+L) optical depths
    emission_raw: Optional[torch.Tensor] = None   # pre-LUT emission
    emission_valid: Optional[torch.Tensor] = None
    color: Optional[torch.Tensor] = None  # (..., 3) Cd, 0 outside the grid


def vec3_param(x, device=None):
    """Scalar-or-(3,) param -> (3,) float32."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.expand(3) if x.ndim == 0 else x


def _trilerp_weights(frac):
    """(..., 8) weights in tap order c = x + 2y + 4z."""
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    wx = (1.0 - fx, fx)
    wy = (1.0 - fy, fy)
    wz = (1.0 - fz, fz)
    return torch.stack([wx[c & 1] * wy[(c >> 1) & 1] * wz[(c >> 2) & 1]
                        for c in range(8)], dim=-1)


def _wsum8(rows, w8):
    """Sum of 8 weighted taps, left to right."""
    acc = rows[..., 0] * w8[..., 0]
    for c in range(1, 8):
        acc = acc + rows[..., c] * w8[..., c]
    return acc


def density_color_lut(scene, params, density):
    """Density-indexed color LUT (QUIRKS #14): index = density / sigma_max
    * 255 / emission_pivot, truncated; an indexed load."""
    idx = torch.clamp(density / scene.max_extinction * 255.0
                      / params.emission_pivot, 0.0, 255.0).to(torch.int64)
    return scene.density_color_lut[idx]


def _emission_lut(scene, params, raw, valid):
    """Emission channel -> blackbody LUT row x emission_scale, 0 where
    not ``valid`` (vpt_tpu/render/tracking.py:245-258; QUIRKS #15: the
    index truncates); an indexed load."""
    idx = torch.clamp(raw * 255.0 / params.emission_pivot, 0.0,
                      255.0).to(torch.int64)
    rgb = scene.emission_lut[idx]
    return torch.where(valid[..., None], rgb * params.emission_scale, 0.0)


def _sphere_block(scene, pos, direction):
    """(hit, t) of the reference sphere; a miss when it is disabled."""
    sph = scene.sphere
    hit, tmin, _ = _sphere_roots(sph.center, sph.radius, pos, direction)
    hit = hit & sph.enabled
    return hit, torch.where(hit, tmin, 3.4e38)


def _rows_index(atlas, flat):
    """Corner-row indices kept in the table: a no-op for finite points,
    whose indices are in range; a lane at a non-finite point (a masked
    lane whose walk went to 1e30, the reference's gather reads NaN
    there) reads row 0 instead of failing."""
    return torch.clamp(flat, 0, atlas.density_corners.shape[0] - 1)


def _row_norm_coords(row, pos):
    """Instance row (Instances.packed_rows) -> trilinear coordinates at
    world ``pos``: (i0 (..., 3) int64, frac, dim (..., 3) int64,
    in_bounds)."""
    ipos = (pos[..., 0:1] * row[..., 0:3] + pos[..., 1:2] * row[..., 3:6]
            + pos[..., 2:3] * row[..., 6:9] + row[..., 9:12])
    bmin = row[..., 12:15]
    dimf = row[..., 15:18]
    npos = (ipos - bmin) / dimf
    inb = torch.all((npos >= 0.0) & (npos <= 1.0), dim=-1)
    x = torch.minimum(torch.clamp(npos * dimf - 0.5, min=0.0), dimf - 1.0)
    i0 = torch.floor(x)
    frac = x - i0
    return i0.to(torch.int64), frac, dimf.to(torch.int64), inb


def _density_from_row(atlas, row, pos):
    """The density of one instance at ``pos``: its row, then one corner
    row; 0 outside its grid."""
    i0, frac, dim, inb = _row_norm_coords(row, pos)
    flat = row[..., 18].to(torch.int64) + (
        i0[..., 2] * dim[..., 1] + i0[..., 1]) * dim[..., 0] + i0[..., 0]
    rows = atlas.density_corners[_rows_index(atlas, flat)]
    return torch.where(inb, _wsum8(rows[..., :8], _trilerp_weights(frac)),
                       0.0)


def _grid_cols(atlas, row, pos, col, width):
    """(the ``width`` columns at ``col`` of one instance's corner row at
    ``pos``, its trilinear weights, in_bounds)."""
    i0, frac, dim, inb = _row_norm_coords(row, pos)
    flat = row[..., 18].to(torch.int64) + (
        i0[..., 2] * dim[..., 1] + i0[..., 1]) * dim[..., 0] + i0[..., 0]
    return (atlas.density_corners[_rows_index(atlas, flat)][
        ..., col:col + width],
            _trilerp_weights(frac), inb)


def _emission_from_row(atlas, row, pos):
    """(raw emission, valid) of one instance at ``pos``: its row's 8
    emission columns; valid only inside its grid and where the grid has
    the channel (QUIRKS #23), 0 elsewhere (vpt_tpu/render/tracking.py:
    87-100)."""
    taps, w8, inb = _grid_cols(atlas, row, pos, unified_layout(atlas)[0], 8)
    valid = (row[..., 19] >= 0.0) & inb
    return torch.where(valid, _wsum8(taps, w8), 0.0), valid


def _color_from_row(atlas, row, pos):
    """Cd of one instance at ``pos`` (..., 3): its row's 24 color
    columns, 0 outside its grid, and WHITE where the grid has no color
    channel, inside its grid or not (vpt_tpu/render/tracking.py:103-117;
    render_kernel.cu:911)."""
    taps, w8, inb = _grid_cols(atlas, row, pos, unified_layout(atlas)[1],
                               24)
    taps = taps.reshape(taps.shape[:-1] + (8, 3)).transpose(-1, -2)
    val = torch.where(inb[..., None], _wsum8(taps, w8[..., None, :]), 0.0)
    return torch.where((row[..., 20] >= 0.0)[..., None], val, 1.0)


def _use_cells(scene) -> bool:
    return (scene.majorant is not None
            and scene.majorant.cell_instances is not None)


def _cell_flat_index(scene, pos):
    """The flat cell of world ``pos`` as the reference's emission and
    color lookups find it: (pos - root_pmin) / extent * R, which may pick
    the next cell where the walk's (pos - root_pmin) / (extent / R) does
    not (vpt_tpu/render/tracking.py:38-43)."""
    R = scene.majorant.resolution
    rel = (pos - scene.root_pmin) / (scene.root_pmax - scene.root_pmin) * R
    ci = torch.clamp(torch.floor(rel).to(torch.int64), 0, R - 1)
    return (ci[..., 2] * R + ci[..., 1]) * R + ci[..., 0]


def _instance_slots(scene, pos):
    """[(valid (...,), instance row (..., 24))] in slot order: the cell's
    listed instances, or every instance in the static loop."""
    inst = scene.instances.packed_rows
    if not _use_cells(scene):
        return [(None, inst[i]) for i in range(scene.instances.count)]
    ids = scene.majorant.cell_instances[_cell_flat_index(scene, pos)].to(
        torch.int64)
    rows = inst[torch.clamp(ids, min=0)]
    return [(ids[..., j] >= 0, rows[..., j, :]) for j in range(ids.shape[-1])]


def scene_density(scene, pos):
    """Raw summed density at world ``pos``: over the cell's listed
    instances, or every instance in order (vpt_tpu/render/tracking.py:
    230-243)."""
    total = torch.zeros(pos.shape[:-1], dtype=torch.float32,
                        device=pos.device)
    for valid, row in _instance_slots(scene, pos):
        d = _density_from_row(scene.atlas, row, pos)
        total = total + (d if valid is None else torch.where(valid, d, 0.0))
    return total


def scene_emission(scene, pos, params):
    """The emission LUT's rows x emission_scale summed over the instances
    (vpt_tpu/render/tracking.py:261-281)."""
    total = torch.zeros(pos.shape[:-1] + (3,), dtype=torch.float32,
                        device=pos.device)
    if not scene.atlas.has_emission:
        return total
    for valid, row in _instance_slots(scene, pos):
        raw, ok = _emission_from_row(scene.atlas, row, pos)
        total = total + _emission_lut(scene, params, raw,
                                      ok if valid is None else ok & valid)
    return total


def scene_color(scene, pos):
    """Cd: the component-wise max over the instances, from 0, so white
    wherever an instance of a grid without color is in the cell's list,
    and everywhere in the loop (vpt_tpu/render/tracking.py:284-303)."""
    if not scene.atlas.has_color:
        return torch.ones(pos.shape[:-1] + (3,), dtype=torch.float32,
                          device=pos.device)
    color = torch.zeros(pos.shape[:-1] + (3,), dtype=torch.float32,
                        device=pos.device)
    for valid, row in _instance_slots(scene, pos):
        c = _color_from_row(scene.atlas, row, pos)
        color = torch.maximum(color, c if valid is None
                              else torch.where(valid[..., None], c, 0.0))
    return color


def _loop_banded_fetch(scene, pos, direction):
    """(density, s_box, t_box) of an instanced scene without cell lists:
    the static loop's density and the packed row's bound and box exit
    (the multi-instance branch of vpt_tpu/render/tracking.py::
    unified_fetch, :340-375)."""
    from vpt_tpu_torch.accel.majorant import local_majorant_query
    t_box, s_box = local_majorant_query(scene.majorant, scene.root_pmin,
                                        scene.root_pmax, pos, direction)
    return scene_density(scene, pos), s_box, t_box


def cell_layout(scene) -> tuple[int, int, int]:
    """(ids column, K, tau channels) of the cell rows: the ids follow
    the packed columns (7, or 79 with the octant columns), the taus of
    accel/shadow.py::_fold_cell_taus follow the ids (0 channels before a
    bake)."""
    major = scene.majorant
    ids_off = major.packed.shape[-1]
    k = major.cell_instances.shape[-1]
    return ids_off, k, (major.cell_rows.shape[-1] - ids_off - k) // 8


def cell_size(scene):
    """The cell grid's (3,) cell size, extent / R, one float32 division
    per axis on every device."""
    return true_div(scene.root_pmax - scene.root_pmin,
                    scene.majorant.resolution)


def _cell_coords(scene, pos):
    """(cell size cs (3,), rel = pos in cells, ci (..., 3) int64, flat
    cell index) of world ``pos``, as the walk computes them: cs = extent
    / R per axis, then (pos - root_pmin) / cs."""
    cs = cell_size(scene)
    R = scene.majorant.resolution
    rel = (pos - scene.root_pmin) / cs
    ci = torch.clamp(torch.floor(rel).to(torch.int64), 0, R - 1)
    flat = (ci[..., 2] * R + ci[..., 1]) * R + ci[..., 0]
    return cs, rel, ci, flat


def _cell_taus(row, rel, ci, tau_off, n_ch):
    """(..., n_ch) trilinear taus from the cell row's corner columns."""
    w8 = _trilerp_weights(torch.clamp(rel - ci.to(torch.float32), 0.0, 1.0))
    return torch.stack([_wsum8(row[..., tau_off + 8 * c:tau_off + 8 * c + 8],
                               w8) for c in range(n_ch)], dim=-1)


def _cells_banded_fetch(scene, pos, direction, with_tau: bool = False):
    """(density, s_box, t_box[, taus]) of an instanced scene from one
    cell row (MajorantGrid.cell_rows) and the K listed instances' rows:
    the box exit, widened on an empty cell by the octant box's; the
    density summed over the valid slots in slot order; with ``with_tau``
    the taus folded into the row (vpt_tpu/render/tracking.py:150-226)."""
    from vpt_tpu_torch.accel.majorant import octant_exit
    cs, rel, ci, flat = _cell_coords(scene, pos)
    row = scene.majorant.cell_rows[flat]
    t_box = row[..., 0]
    cif = ci.to(torch.float32)
    cube_min = scene.root_pmin + (cif - torch.clamp(row[..., 1:4], min=0.0)) \
        * cs
    cube_max = scene.root_pmin + (cif + 1.0 + torch.clamp(row[..., 4:7],
                                                         min=0.0)) * cs
    inv = 1.0 / torch.where(torch.abs(direction) < 1e-12, 1e-12, direction)
    t1 = (cube_min - pos) * inv
    t2 = (cube_max - pos) * inv
    s_box = torch.clamp(_amin3(torch.maximum(t1, t2)), min=0.0)
    ids_off, k, n_ch = cell_layout(scene)
    if ids_off >= 79:
        t_oct = octant_exit(row[..., 7:79], cif, rel, direction / cs)
        s_box = torch.where(t_box <= 0.0,
                            torch.maximum(s_box, torch.clamp(t_oct, min=0.0)),
                            s_box)
    ids = row[..., ids_off:ids_off + k].to(torch.int64)
    rows = scene.instances.packed_rows[torch.clamp(ids, min=0)]
    density = torch.zeros(pos.shape[:-1], dtype=torch.float32,
                          device=pos.device)
    for j in range(k):
        d = _density_from_row(scene.atlas, rows[..., j, :], pos)
        density = density + torch.where(ids[..., j] >= 0, d, 0.0)
    if not with_tau:
        return density, s_box, t_box
    if n_ch == 0:
        raise ValueError("with_tau: cell rows carry no tau columns "
                         "(run accel.shadow.attach_shadow_cache)")
    return density, s_box, t_box, _cell_taus(row, rel, ci, ids_off + k, n_ch)


def _unified_fetch_single(scene, params, pos, direction,
                          with_tau: bool = False, banded: bool = False,
                          full: bool = False):
    """One corner-row load at world positions ``pos``.

    banded=True: (density, s_box, t_box[, tau]) — s_box is the exit
    distance of the bounded-density box around the base voxel and t_box
    its bound (0 = empty); out-of-grid positions report an empty box
    reaching to the grid entry (1e30 when the ray misses the grid).
    banded=False: (density, skip_dt[, tau]), skip_dt > 0 only in
    guaranteed-empty regions.  full=True returns a FetchResult, with the
    emission and color channels where the grid has them.  bfloat16 rows
    are read as float32; with the octant columns an empty box's exit is
    widened by the anchored box of the ray's octant and major axis
    (vpt_tpu/render/tracking.py:502-513)."""
    if not params.use_majorant:
        raise NotImplementedError("use_majorant=False is not ported")
    inv = scene.instances.inv_xform[0]
    row = scene.instances.packed_rows[0]
    bmin = row[12:15]
    dimf = row[15:18]
    off = int(row[18])

    ipos = transform_point(inv, pos)
    idir = (direction[..., 0:1] * inv[0, :3] + direction[..., 1:2]
            * inv[1, :3] + direction[..., 2:3] * inv[2, :3])
    npos = (ipos - bmin) / dimf
    inb = torch.all((npos >= 0.0) & (npos <= 1.0), dim=-1)
    x_u = npos * dimf - 0.5
    x = torch.minimum(torch.clamp(x_u, min=0.0), dimf - 1.0)
    i0f = torch.floor(x)
    frac = x - i0f
    i0 = i0f.to(torch.int64)
    dim = [int(v) for v in dimf.tolist()]
    flat = off + (i0[..., 2] * dim[1] + i0[..., 1]) * dim[0] + i0[..., 0]
    rows = scene.atlas.density_corners[_rows_index(scene.atlas, flat)].float()
    w8 = _trilerp_weights(frac)
    density = torch.where(inb, _wsum8(rows[..., :8], w8), 0.0)

    em_off, col_off, tau_off = unified_layout(scene.atlas)
    tau = None
    if with_tau:
        n_ch = (rows.shape[-1] - tau_off) // 8
        if n_ch < 1:
            raise ValueError("shadow_mode='cached' but the scene has no "
                             "baked cache — call accel.shadow."
                             "attach_shadow_cache first")
        tau = torch.stack([_wsum8(rows[..., tau_off + 8 * c:
                                       tau_off + 8 * c + 8], w8)
                           for c in range(n_ch)], dim=-1)

    t_box = rows[..., 8]
    cube_min = i0f - torch.clamp(rows[..., 9:12], min=0.0)
    cube_max = i0f + 1.0 + torch.clamp(rows[..., 12:15], min=0.0)
    safe_dir = torch.where(torch.abs(idir) < 1e-12, 1e-12, idir)
    t1 = (cube_min - x_u) / safe_dir
    t2 = (cube_max - x_u) / safe_dir
    t_exit = _amin3(torch.maximum(t1, t2))
    if scene.atlas.octant_cols:
        from vpt_tpu_torch.accel.majorant import octant_exit
        t_oct = octant_exit(rows[..., 15:87], i0f, x_u, idir)
        t_exit = torch.where(t_box <= 0.0, torch.maximum(t_exit, t_oct),
                             t_exit)
    in_skip = inb & (t_box <= 0.0)

    t1b = (bmin - ipos) / safe_dir
    t2b = (bmin + dimf - ipos) / safe_dir
    t_entry = _amax3(torch.minimum(t1b, t2b))
    t_leave = _amin3(torch.maximum(t1b, t2b))
    misses_box = (t_leave < torch.clamp(t_entry, min=0.0)) | (t_leave <= 0.0)
    t_entry = torch.where(misses_box, 1e30, torch.clamp(t_entry, min=0.0))

    if banded or full:
        s_box = torch.where(inb, torch.clamp(t_exit, min=0.0),
                            torch.clamp(t_entry, min=0.0))
        t_out = torch.where(inb, t_box, 0.0)
        if full:
            emission_raw = emission_valid = color = None
            if em_off >= 0:
                emission_raw = _wsum8(rows[..., em_off:em_off + 8], w8)
                emission_valid = inb
            if col_off >= 0:
                crows = rows[..., col_off:col_off + 24].reshape(
                    rows.shape[:-1] + (8, 3))
                color = _wsum8(crows.transpose(-1, -2), w8[..., None, :])
                color = torch.where(inb[..., None], color, 0.0)
            return FetchResult(density, s_box, t_out, tau, emission_raw,
                               emission_valid, color)
        return ((density, s_box, t_out, tau) if with_tau
                else (density, s_box, t_out))
    skip_in = torch.where(t_exit > 0.0, t_exit + 1e-3, 0.0)
    skip_out = torch.where(t_entry > 0.0, t_entry + 1e-3, 0.0)
    skip_dt = torch.where(in_skip, skip_in, torch.where(inb, 0.0, skip_out))
    return (density, skip_dt, tau) if with_tau else (density, skip_dt)


def unified_fetch_full(scene, params, pos, direction, with_tau=False):
    """The fused engine's one-load-per-step fetch."""
    return _unified_fetch_single(scene, params, pos, direction,
                                 with_tau=with_tau, banded=True, full=True)


# ---------------------------------------------------------------------------
# the reference engine's walks (vpt_tpu/render/tracking.py:575-740)
# ---------------------------------------------------------------------------

def unified_fetch(scene, params, pos, direction):
    """(density, skip_dt) at world ``pos``: skip_dt > 0 only where the
    region ahead is guaranteed empty, the distance the walk may jump
    (vpt_tpu/render/tracking.py:306-375, not banded).  A single grid reads
    its corner row; an instanced scene sums its instances and asks the
    majorant grid's packed row for the empty box."""
    if scene.instances.count == 1 and not _use_cells(scene):
        return _unified_fetch_single(scene, params, pos, direction)
    density = scene_density(scene, pos)
    if scene.majorant is None:
        return density, torch.zeros_like(density)
    from vpt_tpu_torch.accel.majorant import empty_skip_t
    empty, t_exit = empty_skip_t(scene.majorant, scene.root_pmin,
                                 scene.root_pmax, pos, direction)
    return density, torch.where(empty & (density <= 0.0) & (t_exit > 0.0),
                                t_exit + 1e-3, 0.0)


def _over(x: float, t):
    """x / t as one float32 division (a Python number over a tensor is
    reciprocal(t) * x in torch, rounded twice)."""
    return torch.tensor(x, dtype=torch.float32, device=t.device) / t


def _free_flight(u, rate_inv):
    """-log1p(-u) * rate_inv: the exponential step, in the reference's
    form (log1p, not log(1 - u), so a rare accept does not flip)."""
    return -torch.log1p(-u) * rate_inv


def delta_track(scene, params, key, pos, direction, active):
    """Free-path sampling (``sample``, render_kernel.cu:1556-1681) for
    (B, 3) rays at or inside the root box, step ``s`` drawing
    uniform(fold_in(key, s), (B, 2)); at most max_track_steps steps.

    Returns (new_pos, interaction, value, hit_sphere, alpha_add, steps):
    ``value`` is WHITE on an exit without interaction, albedo * Cd * LUT
    / extinction * energy_inject at a collision (render_kernel.cu:1674).
    A walk cut by the step budget returns the point it reached, with
    value WHITE (vpt_tpu/render/tracking.py:575-637)."""
    B, dev = pos.shape[0], pos.device
    sigma_max = scene.max_extinction * params.density_mult
    inv_rate = 1.0 / torch.clamp(sigma_max, min=1e-12)
    _, _, t_box = aabb_intersect(scene.root_pmin, scene.root_pmax, pos,
                                 direction)
    sph_hit, t_sph = _sphere_block(scene, pos, direction)
    sphere_limited = sph_hit & (t_sph < t_box)
    distance = torch.where(sphere_limited, t_sph, t_box)

    _, skip = unified_fetch(scene, params, pos, direction)
    t = torch.zeros(B, dtype=torch.float32, device=dev)
    cur = active.clone()
    interaction = torch.zeros(B, dtype=torch.bool, device=dev)
    alpha_add = torch.zeros(B, dtype=torch.float32, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    for step in range(params.max_track_steps):
        if not bool(cur.any()):
            break
        u = rng.uniform(rng.fold_in(key, step), (B, 2), dev)
        do_skip = cur & (skip > 0.0)
        dt = torch.where(do_skip, skip, _free_flight(u[:, 0], inv_rate))
        t_new = torch.where(cur, t + dt, t)
        exited = cur & (t_new >= distance)
        d_new, skip = unified_fetch(scene, params,
                                    pos + direction * t_new[:, None],
                                    direction)
        sampled = cur & ~do_skip & ~exited
        alpha_add = alpha_add + torch.where(sampled, d_new, 0.0)
        accept = sampled & (d_new / scene.max_extinction > u[:, 1])
        interaction = interaction | accept
        cur = cur & ~exited & ~accept
        steps = steps + cur.to(torch.int32)
        t = t_new

    new_pos = pos + direction * t[:, None]
    hit_sphere = active & sphere_limited & ~interaction
    value = torch.ones((B, 3), dtype=torch.float32, device=dev)
    if bool(interaction.any()):
        lut = density_color_lut(scene, params, scene_density(scene, new_pos))
        coll = (vec3_param(params.albedo, dev) * scene_color(scene, new_pos)
                * lut / vec3_param(params.extinction, dev)
                ) * params.energy_inject
        value = torch.where(interaction[:, None], coll, value)
    return new_pos, interaction, value, hit_sphere, alpha_add, steps


def transmittance(scene, params, key, pos, direction, active=None):
    """Residual ratio tracking (``Tr``, render_kernel.cu:1138-1273): the
    control variate sigma_c = the scene's min extinction, T_c =
    exp(-sigma_c distance); a start outside the box is pushed to it, a
    ray that misses it has Tr 1, one that meets the sphere 0 (QUIRKS #7);
    step ``s`` draws uniform(fold_in(key, s), (B,))
    (vpt_tpu/render/tracking.py:640-693).  Lanes outside ``active`` (all
    by default) take no step: their Tr is the caller's to ignore."""
    B, dev = pos.shape[0], pos.device
    root_min, root_max = scene.root_pmin, scene.root_pmax
    hit, t_entry, _ = aabb_intersect(root_min, root_max, pos, direction)
    inside = aabb_contains(root_min, root_max, pos)
    miss = ~inside & ~hit
    start = torch.where((~inside & hit)[:, None],
                        pos + direction * (t_entry + EPS)[:, None], pos)
    _, _, distance = aabb_intersect(root_min, root_max, start, direction)
    distance = torch.clamp(distance, min=0.0)
    sph_hit, _ = _sphere_block(scene, start, direction)

    sigma_c = scene.min_extinction
    sigma_r = torch.clamp(scene.max_extinction - sigma_c, min=1e-12)
    rate_inv = _over(params.tr_depth, sigma_r)
    t_c = torch.exp(-sigma_c * distance)

    _, skip = unified_fetch(scene, params, start, direction)
    t = torch.zeros(B, dtype=torch.float32, device=dev)
    tr = torch.ones(B, dtype=torch.float32, device=dev)
    cur = ~miss & ~sph_hit
    if active is not None:
        cur = cur & active
    for step in range(params.max_track_steps):
        if not bool(cur.any()):
            break
        u = rng.uniform(rng.fold_in(key, step), (B,), dev)
        do_skip = cur & (skip > 0.0)
        dt = torch.where(do_skip, skip, _free_flight(u, rate_inv))
        t_new = torch.where(cur, t + dt, t)
        exited = cur & (t_new >= distance)
        d_new, skip = unified_fetch(scene, params,
                                    start + direction * t_new[:, None],
                                    direction)
        sampled = cur & ~do_skip & ~exited
        tr = torch.where(sampled, tr * (1.0 - (d_new - sigma_c) / sigma_r),
                         tr)
        cur = cur & ~exited & (torch.abs(tr) >= EPS)
        t = t_new
    tr = torch.clamp(tr * t_c, 0.0, 1.0)
    tr = torch.where(miss, 1.0, tr)
    return torch.where(sph_hit, 0.0, tr)


def estimate_emission(scene, params, key, pos, direction, active=None,
                      max_extinction=None):
    """The rate-weighted emission line integral (render_kernel.cu:
    1275-1339, QUIRKS #21): a walk at the ratio-tracking rate
    tr_depth / (sigma * extinction.x) that sums scene_emission at every
    sampled point, with no empty-space jumps (emission may lie where the
    density is 0); ``max_extinction`` overrides sigma, the scene's max
    extinction (vpt_tpu/render/tracking.py:696-740)."""
    B, dev = pos.shape[0], pos.device
    emission = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    if not scene.atlas.has_emission:
        return emission
    sig = scene.max_extinction if max_extinction is None else max_extinction
    ext_x = vec3_param(params.extinction, dev)[0]
    rate_inv = _over(params.tr_depth, torch.clamp(sig * ext_x, min=1e-12))
    _, _, distance = aabb_intersect(scene.root_pmin, scene.root_pmax, pos,
                                    direction)
    distance = torch.clamp(distance, min=0.0)
    cur = (torch.ones(B, dtype=torch.bool, device=dev) if active is None
           else active.clone())
    t = torch.zeros(B, dtype=torch.float32, device=dev)
    for step in range(params.max_track_steps):
        if not bool(cur.any()):
            break
        u = rng.uniform(rng.fold_in(key, step), (B,), dev)
        t_new = torch.where(cur, t + _free_flight(u, rate_inv), t)
        exited = cur & (t_new >= distance)
        sampled = cur & ~exited
        e = scene_emission(scene, pos + direction * t_new[:, None], params)
        emission = emission + torch.where(sampled[:, None], e, 0.0)
        cur = sampled
        t = t_new
    return emission
