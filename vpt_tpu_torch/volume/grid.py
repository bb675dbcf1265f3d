"""Dense volume atlas and the corner-row packers (port of
vpt_tpu/volume/grid.py).

A trilinear fetch reads ONE row of the corner table: the 2x2x2
neighbourhood of the base voxel (tap order c = x + 2y + 4z), then the
acceleration channels T_box (col 8) and the empty-box extents
(cols 9:15), then, with ``octant_boxes``, the 72 per-(octant x
major-axis) anchored extents (cols 15:87), then the grid's emission taps
(8 columns) and color taps (24: corner-major, channel-minor) where it
has those channels, then the shadow-cache taus that accel/shadow.py
appends (``unified_layout``).

The packers run on the host in numpy, like the reference's.  The
empty-box growth, the slow part at production size, is the greedy sweep
of native/vdb_codec.cpp (``grow_empty_boxes``) vectorised in torch on
the scene's device; how long it took is logged.  The octant extents
(``_octant_box_extents``) grow the same way; the majorant cell grid of
instanced scenes carries them too (accel/majorant.py).

``corner_dtype="bfloat16"`` stores the rows in torch.bfloat16, cast in
torch (no ml_dtypes): half the bytes of a row (``to_corner_dtype``).
The grids of a scene pack one after another into one table.
"""

from __future__ import annotations

import functools
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from vpt_tpu_torch.core.device import DEFAULT_DEVICE

log = logging.getLogger("vpt_tpu_torch")

BAND_DIVISORS = (0.0, 1 / 8, 1 / 4, 1 / 2, 1.0)


@dataclass(frozen=True)
class HostGrid:
    """Host-side staging for one grid before packing."""

    density_zyx: np.ndarray
    emission_zyx: np.ndarray | None
    color_zyx: np.ndarray | None
    bbox_min: np.ndarray          # int32 (3,) index space
    dim: np.ndarray               # int32 (3,) nx, ny, nz
    transform: np.ndarray         # float64 4x4 index->world, row-vector
    voxel_size: float
    max_density: float
    min_density: float


@dataclass(frozen=True)
class VolumeAtlas:
    """Device tensors of a scene's G grids."""

    density: torch.Tensor          # (V,) f32 raw voxels (the bakes read it)
    # (V, 15 [+ 72 octant] [+ 8 emission] [+ 24 color] [+ 8 (1+L) taus]),
    # float32 or bfloat16
    density_corners: torch.Tensor
    offset: torch.Tensor           # (G,) int32 first row of each grid
    # (G,) int32 each grid's start in a table of its channel alone, -1
    # where it lacks the channel (the reference's values)
    emission_offset: torch.Tensor
    color_offset: torch.Tensor
    dim: torch.Tensor              # (G, 3) int32 nx, ny, nz
    bmin: torch.Tensor             # (G, 3) f32
    max_density: torch.Tensor      # (G,) f32
    min_density: torch.Tensor      # (G,) f32
    voxel_size: torch.Tensor       # (G,) f32
    # 72 when the rows carry the octant extents in cols 15:87, else 0;
    # shifts every later channel (unified_layout)
    octant_cols: int = 0

    @functools.cached_property
    def has_emission(self) -> bool:
        """Any grid has an emission channel (the row's 8 columns)."""
        return int(self.emission_offset.max()) >= 0

    @functools.cached_property
    def has_color(self) -> bool:
        """Any grid has a color channel (the row's 24 columns)."""
        return int(self.color_offset.max()) >= 0


def unified_layout(atlas) -> tuple[int, int, int]:
    """(emission_off, color_off, tau_off) in the corner row; -1 when a
    channel is absent (vpt_tpu/volume/grid.py:562-573)."""
    off = 15 + atlas.octant_cols
    em = off if atlas.has_emission else -1
    off += 8 if atlas.has_emission else 0
    col = off if atlas.has_color else -1
    off += 24 if atlas.has_color else 0
    return em, col, off


def _corner_taps(d, shift_index):
    """The 8 edge-clamped corner shifts of a zyx field."""
    nz, ny, nx = d.shape
    taps = []
    for c in range(8):
        dx, dy, dz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        iz, iy, ix = (shift_index(nz, dz), shift_index(ny, dy),
                      shift_index(nx, dx))
        taps.append(d[iz][:, iy][:, :, ix])
    return taps


def _corner_pack_plain(d_zyx: torch.Tensor) -> torch.Tensor:
    """(nz,ny,nx) tensor -> (nx*ny*nz, 8) rows: the edge-clamped 2x2x2
    neighbourhood of each voxel, without acceleration channels (the
    shadow-cache tau channels).  Runs on the tensor's device."""
    dev = d_zyx.device

    def idx(n, o):
        return torch.clamp(torch.arange(n, device=dev) + o, max=n - 1)
    taps = _corner_taps(d_zyx, idx)
    return torch.stack([t.reshape(-1) for t in taps], dim=1)


def _grow_boxes_sweep(ii_flat, coords, r, nx, ny, nz,
                      device=DEFAULT_DEVICE):
    """Greedy empty-box growth on ``device``, (6, n) int32 numpy:
    vpt_tpu/volume/grid.py::_grow_boxes_numpy in torch.  Per direction,
    binary growth by halving steps, each probe an O(1) occupancy query
    on the integral image."""
    dev = torch.device(device)
    ii = torch.as_tensor(ii_flat, device=dev).to(torch.int64)
    sx, sxy = nx + 1, (nx + 1) * (ny + 1)
    c = torch.as_tensor(coords, device=dev).to(torch.int64)
    xx, yy, zz = c[0], c[1], c[2]
    r = torch.as_tensor(r, device=dev).to(torch.int64)
    ext = torch.stack([r] * 6)

    def at(z, y, x):
        return ii[z * sxy + y * sx + x]

    def occ_count(z0, z1, y0, y1, x0, x1):
        z0, z1 = torch.clamp(z0, 0, nz), torch.clamp(z1 + 1, 0, nz)
        y0, y1 = torch.clamp(y0, 0, ny), torch.clamp(y1 + 1, 0, ny)
        x0, x1 = torch.clamp(x0, 0, nx), torch.clamp(x1 + 1, 0, nx)
        return (at(z1, y1, x1) - at(z0, y1, x1) - at(z1, y0, x1)
                - at(z1, y1, x0) + at(z0, y0, x1) + at(z0, y1, x0)
                + at(z1, y0, x0) - at(z0, y0, x0))

    for slot, n_axis in ((3, nx), (0, nx), (4, ny), (1, ny), (5, nz),
                         (2, nz)):
        add = 1 << max(int(np.ceil(np.log2(max(n_axis, 2)))), 0)
        while add >= 1:
            x0, x1 = xx - ext[0], xx + ext[3]
            y0, y1 = yy - ext[1], yy + ext[4]
            z0, z1 = zz - ext[2], zz + ext[5]
            if slot == 3:
                x0, x1 = x1 + 1, x1 + add
            elif slot == 0:
                x0, x1 = x0 - add, x0 - 1
            elif slot == 4:
                y0, y1 = y1 + 1, y1 + add
            elif slot == 1:
                y0, y1 = y0 - add, y0 - 1
            elif slot == 5:
                z0, z1 = z1 + 1, z1 + add
            else:
                z0, z1 = z0 - add, z0 - 1
            ok = occ_count(z0, z1, y0, y1, x0, x1) == 0
            ext[slot] += ok.to(torch.int64) * add
            add >>= 1
    return ext.to(torch.int32).cpu().numpy()


def _empty_box_extents(occ: np.ndarray, where: np.ndarray | None = None,
                       device=DEFAULT_DEVICE) -> np.ndarray:
    """Per-voxel guaranteed-empty boxes, (6, nz, ny, nx) float32 extents
    [xm, ym, zm, xp, yp, zp] (voxels); -1 for occupied or unselected
    voxels.  Greedy growth from the chebyshev cube, validated against an
    occupancy integral image (vpt_tpu/volume/grid.py:244-285)."""
    from scipy import ndimage
    nz, ny, nx = occ.shape
    free = ~occ
    sel = free if where is None else (free & where)
    zz, yy, xx = np.nonzero(sel)
    out = np.full((6, nz, ny, nx), -1.0, np.float32)
    if zz.size == 0:
        return out
    cheb = ndimage.distance_transform_cdt(free, metric="chessboard")
    r = np.maximum(cheb[zz, yy, xx].astype(np.int32) - 1, 0)
    ii = np.zeros((nz + 1, ny + 1, nx + 1), np.int32)
    ii[1:, 1:, 1:] = occ.astype(np.int32).cumsum(0).cumsum(1).cumsum(2)
    coords = np.ascontiguousarray(np.stack([xx, yy, zz]).astype(np.int32))
    t0 = time.perf_counter()
    ext = _grow_boxes_sweep(ii.reshape(-1), coords, r, nx, ny, nz, device)
    log.info("box growth (%d voxels) on %s: %.3f s", coords.shape[1], device,
             time.perf_counter() - t0)
    out[:, zz, yy, xx] = ext.astype(np.float32)
    return out


OCTANT_COLS = 72


def _grow_octant_sweep(ii_flat, coords, r0, nx, ny, nz,
                       device=DEFAULT_DEVICE):
    """The 24 anchored boxes of every voxel on ``device``, (72, n) int32
    numpy in [9 octant + 3 major + axis] order: native/vdb_codec.cpp
    ``grow_octant_boxes`` (and its numpy fallback,
    vpt_tpu/volume/grid.py:403-471) with the boxes side by side.  Each
    box takes the same probes in the same order: its major axis over the
    halving sizes, then its two minor axes interleaved per size.  The 8
    boxes of one major axis probe the same axis at every step, so each
    probe recomputes that axis's slab and reuses the other two axes'
    bounds.  The voxels go in chunks (all at once on the card)."""
    dev = torch.device(device)
    chunk = 1 << 30 if dev.type == "cuda" else 1 << 14
    ii = torch.as_tensor(ii_flat, device=dev).to(torch.int32)
    lim = (nx, ny, nz)
    stride = (1, nx + 1, (nx + 1) * (ny + 1))
    octant = torch.arange(8, device=dev)
    pos_dir = [((octant >> a) & 1).to(torch.bool)[:, None] for a in range(3)]
    n_max = max(nx, ny, nz)
    adds = [1 << k for k in range(int(np.ceil(np.log2(max(n_max, 2)))),
                                  -1, -1)]
    coords = torch.as_tensor(coords, device=dev).to(torch.int32)
    r0 = torch.as_tensor(r0, device=dev).to(torch.int32)
    n = coords.shape[1]
    out = torch.empty((8, 3, 3, n), dtype=torch.int32, device=dev)

    def bounds(a, pos, e):
        """The box's clamped, stride-scaled [lo, hi + 1) on axis a."""
        lo = torch.where(pos_dir[a], pos, pos - e)
        hi = torch.where(pos_dir[a], pos + e, pos)
        return (torch.clamp(lo, 0, lim[a]) * stride[a],
                torch.clamp(hi + 1, 0, lim[a]) * stride[a])

    for c0 in range(0, n, chunk):
        pos = [coords[a, None, c0:c0 + chunk] for a in range(3)]
        for m in range(3):
            minors = [a for a in range(3) if a != m]
            probes = [(m, add) for add in adds]
            probes += [(a, add) for add in adds for a in minors]
            ext = [r0[None, c0:c0 + chunk].repeat(8, 1) for _ in range(3)]
            box = [bounds(a, pos[a], ext[a]) for a in range(3)]
            for a, add in probes:
                # the slab just past the box's face on axis a, add deep
                base = torch.where(pos_dir[a], pos[a] + ext[a] + 1,
                                   pos[a] - ext[a] - add)
                slab = (torch.clamp(base, 0, lim[a]) * stride[a],
                        torch.clamp(base + add, 0, lim[a]) * stride[a])
                (x0, x1), (y0, y1), (z0, z1) = [
                    slab if b == a else box[b] for b in range(3)]
                zy = {(zi, yi): z + y for zi, z in ((1, z1), (0, z0))
                      for yi, y in ((1, y1), (0, y0))}

                def at(zi, yi, x):
                    return torch.index_select(
                        ii, 0, (zy[zi, yi] + x).reshape(-1)).reshape(x.shape)
                count = (at(1, 1, x1) - at(0, 1, x1) - at(1, 0, x1)
                         - at(1, 1, x0) + at(0, 0, x1) + at(0, 1, x0)
                         + at(1, 0, x0) - at(0, 0, x0))
                ext[a] = ext[a] + (count == 0).to(torch.int32) * add
                box[a] = bounds(a, pos[a], ext[a])
            for o in range(8):
                out[o, m, :, c0:c0 + chunk] = torch.stack([e[o] for e in ext])
    return out.reshape(OCTANT_COLS, n).cpu().numpy()


def _octant_box_extents(occ: np.ndarray,
                        device=DEFAULT_DEVICE) -> np.ndarray:
    """Per-voxel per-(octant x major-axis) anchored empty-box extents,
    (72, nz, ny, nx) float32 (vpt_tpu/volume/grid.py:354-473): for free
    voxel v, octant o = sx + 2 sy + 4 sz (bit set = positive direction)
    and major axis m, cols [9 o + 3 m : 9 o + 3 m + 3] hold extents
    (ex, ey, ez) >= 0 such that the box from v to v + sign * e per axis
    (inclusive, voxels) holds no occupied voxel; occupied voxels get 0.
    Grown from the chebyshev cube on ``device``; the time is logged."""
    from scipy import ndimage
    nz, ny, nx = occ.shape
    free = ~occ
    zz, yy, xx = np.nonzero(free)
    out = np.zeros((OCTANT_COLS, nz, ny, nx), np.float32)
    if zz.size == 0:
        return out
    cheb = ndimage.distance_transform_cdt(free, metric="chessboard")
    r0 = np.maximum(cheb[zz, yy, xx].astype(np.int32) - 1, 0)
    ii = np.zeros((nz + 1, ny + 1, nx + 1), np.int32)
    ii[1:, 1:, 1:] = occ.astype(np.int32).cumsum(0).cumsum(1).cumsum(2)
    coords = np.ascontiguousarray(np.stack([xx, yy, zz]).astype(np.int32))
    t0 = time.perf_counter()
    ext = _grow_octant_sweep(ii.reshape(-1), coords, r0, nx, ny, nz, device)
    log.info("octant box growth (%d voxels) on %s: %.3f s", zz.size, device,
             time.perf_counter() - t0)
    out[:, zz, yy, xx] = ext.astype(np.float32)
    return out


def _max3(d_zyx: np.ndarray) -> np.ndarray:
    """Max over each voxel's 3^3 neighbourhood: it bounds every trilinear
    sample whose base voxel is that one (roll wrap only over-estimates,
    which is safe)."""
    maj = d_zyx.copy()
    for axis in (0, 1, 2):
        m = np.maximum(maj, np.roll(maj, 1, axis=axis))
        maj = np.maximum(m, np.roll(maj, -1, axis=axis))
    return maj


def _corner_pack(d_zyx: np.ndarray, band_divisors: tuple | None = None,
                 device=DEFAULT_DEVICE,
                 emit_zyx: np.ndarray | None = None,
                 octant_boxes: bool = False) -> np.ndarray:
    """(nz,ny,nx) -> (V, 15 [+ 72]) rows: 8 edge-clamped taps, T_box (a
    density bound for every trilinear sample whose base voxel lies in the
    box; banded at BAND_DIVISORS x the grid max, 0 = empty), the box's
    extents and, with ``octant_boxes``, the 72 octant extents of the
    voxels whose 3^3 majorant is 0 (vpt_tpu/volume/grid.py:474-559).

    ``emit_zyx``: the emission channel, whose 3^3 majorant joins the
    occupancy of the zero band and of the octant boxes, so that an empty
    box is emission-free too and the EMIT walk may jump it; boxes only
    shrink, so MARCH and SHADOW stay exact (vpt_tpu/volume/grid.py:
    511-526, :548-556)."""
    nz, ny, nx = d_zyx.shape
    out = np.empty((15, nz, ny, nx), np.float32)
    for c, tap in enumerate(_corner_taps(
            d_zyx, lambda n, o: np.minimum(np.arange(n) + o, n - 1))):
        out[c] = tap
    maj = _max3(d_zyx)
    extra_occ = (None if emit_zyx is None
                 else _max3(np.asarray(emit_zyx, np.float32)) > 0.0)
    gmax = float(maj.max())
    bands = [gmax * f for f in (band_divisors or BAND_DIVISORS)]
    band_idx = np.zeros(maj.shape, np.int8)
    for b, t in enumerate(bands):
        band_idx[maj > t] = min(b + 1, len(bands) - 1)
    t_box = np.zeros(maj.shape, np.float32)
    ext = np.zeros((6,) + maj.shape, np.float32)
    for b, t in enumerate(bands):
        sel = band_idx == b
        if not sel.any():
            continue
        occ = maj > t
        if t <= 0.0 and extra_occ is not None:
            occ = occ | extra_occ
        eb = _empty_box_extents(occ, where=sel, device=device)
        ext[:, sel] = eb[:, sel]
        t_box[sel] = t
    out[8] = t_box
    out[9:15] = ext
    if octant_boxes:
        occ0 = maj > 0.0
        if extra_occ is not None:
            occ0 = occ0 | extra_occ
        out = np.concatenate([out, _octant_box_extents(occ0, device=device)])
    return np.ascontiguousarray(out.reshape(out.shape[0], -1).T)


def to_corner_dtype(rows: torch.Tensor, corner_dtype: str,
                    octant_cols: int = 0) -> torch.Tensor:
    """The float32 corner rows in ``corner_dtype`` ("float32" or
    "bfloat16"), on their device.

    bfloat16 rounds to nearest even (the cast of torch and of ml_dtypes
    alike), except the box extents (cols 9:15 + octant_cols), which
    round DOWN, so that an empty box never claims a voxel it does not
    hold: where the nearest bfloat16 lies above the float32 value, the
    bit pattern steps one ulp toward -inf.  T_box (col 8) keeps the
    nearest rounding: every tap of a row is at most its T_box in
    float32, and rounding is monotone, so every bfloat16 tap, and every
    interpolated density, stays at most the bfloat16 T_box; the bound
    holds without rounding up.

    The reference (vpt_tpu/volume/grid.py:576-598,
    ``_bf16_conservative_up`` / ``_down``) steps one float32 ulp and casts
    back, which rounds back to the nearest value: its extents are the
    nearest bfloat16, which lies above the float32 count for about half
    of the odd counts above 256 (bf16 holds integers exactly up to 256).
    Such a box claims one voxel layer more than it holds.  Up to 256 the
    two agree bit for bit (ROADMAP C, the known faults of the
    reference)."""
    if corner_dtype == "float32":
        return rows.to(torch.float32)
    if corner_dtype != "bfloat16":
        raise ValueError(f"corner_dtype {corner_dtype!r}")
    out = rows.to(torch.bfloat16)
    ext = slice(9, 15 + octant_cols)
    want, got = rows[:, ext], out[:, ext]
    high = got.to(torch.float32) > want
    bits = got.view(torch.int16)
    down = torch.where(bits < 0, bits + 1, bits - 1)
    out[:, ext] = torch.where(high, down, bits).view(torch.bfloat16)
    return out


def build_atlas(host_grids: list[HostGrid], band_divisors=None,
                device=DEFAULT_DEVICE, corner_dtype: str = "float32",
                octant_boxes: bool = False) -> VolumeAtlas:
    """Pack the grids into device tensors, their corner rows one after
    another (grid g's at ``offset[g]``), in ``corner_dtype``
    (to_corner_dtype), with the 72 octant columns after the 15 density
    columns where ``octant_boxes``, then the 8 emission and 24 color
    columns wherever any grid has that channel: zeros (emission) and ones
    (white) for a grid without it (vpt_tpu/volume/grid.py:600-690).  The
    channel offsets are the reference's: each grid's start in a table of
    that channel alone, -1 where the grid lacks it; the walk reads the
    channel from the unified row at the density offset."""
    any_em = any(g.emission_zyx is not None for g in host_grids)
    any_col = any(g.color_zyx is not None for g in host_grids)
    parts, offs, eoffs, coffs = [], [], [], []
    dcur = ecur = ccur = 0
    for g in host_grids:
        nvox = int(np.prod(g.density_zyx.shape))
        offs.append(dcur)
        dcur += nvox
        eoffs.append(ecur if g.emission_zyx is not None else -1)
        ecur += nvox if g.emission_zyx is not None else 0
        coffs.append(ccur if g.color_zyx is not None else -1)
        ccur += nvox if g.color_zyx is not None else 0
        part = [_corner_pack(np.asarray(g.density_zyx, np.float32),
                             band_divisors, device=device,
                             emit_zyx=g.emission_zyx,
                             octant_boxes=octant_boxes)]
        if any_em:
            part.append(np.zeros((nvox, 8), np.float32)
                        if g.emission_zyx is None else
                        _corner_pack_plain(torch.as_tensor(np.asarray(
                            g.emission_zyx, np.float32))).numpy())
        if any_col:
            if g.color_zyx is None:
                part.append(np.ones((nvox, 24), np.float32))
            else:
                col = torch.as_tensor(np.asarray(g.color_zyx, np.float32))
                part.append(torch.stack(
                    [_corner_pack_plain(col[..., ch]) for ch in range(3)],
                    -1).reshape(-1, 24).numpy())
        parts.append(np.concatenate(part, axis=1) if len(part) > 1
                     else part[0])
    corners = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    oct_cols = OCTANT_COLS if octant_boxes else 0
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return VolumeAtlas(
        density=torch.as_tensor(np.concatenate(
            [np.asarray(g.density_zyx, np.float32).reshape(-1)
             for g in host_grids]), **f32),
        density_corners=to_corner_dtype(torch.as_tensor(corners, **f32),
                                        corner_dtype, oct_cols),
        offset=torch.tensor(offs, **i32),
        emission_offset=torch.tensor(eoffs, **i32),
        color_offset=torch.tensor(coffs, **i32),
        dim=torch.as_tensor(np.stack([np.asarray(g.dim, np.int32)
                                      for g in host_grids]), device=device),
        bmin=torch.as_tensor(np.stack([np.asarray(g.bbox_min, np.float32)
                                       for g in host_grids]), **f32),
        max_density=torch.tensor([g.max_density for g in host_grids], **f32),
        min_density=torch.tensor([g.min_density for g in host_grids], **f32),
        voxel_size=torch.tensor([g.voxel_size for g in host_grids], **f32),
        octant_cols=oct_cols)
