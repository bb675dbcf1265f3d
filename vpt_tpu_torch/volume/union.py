"""Union grids: an instanced scene resampled onto one world grid (port of
vpt_tpu/volume/union.py).

``resample_union_grid`` evaluates the instances' summed density and
emission and their component-wise max color (render/tracking.py::
scene_density, scene_emission, scene_color) at every voxel centre of a
world grid over the root box, so the scene renders through the single
instance's path: one corner row a step, its octant columns and cached
taus.  An approximation, whose field error ``union_field_error`` and
``union_error_at_resolution`` measure against the exact per-instance
density (``exact_density_at``).

One resample serves the union grid and the world shadow bake of an
instanced scene (accel/shadow.py::_union_density_from_scene):
``resample_instances`` evaluates each instance on the voxels of its box
(widened a voxel) with accel/shadow.py::_trilinear_index, float64
coordinates rounded to float32 after each tap, on the output's device.
It adds the instances in order, as the reference's loop does, but not
one at a time: the instances go in waves, each instance in the wave after
the last earlier one whose box it overlaps, so that the instances of one
wave write disjoint voxels and each voxel takes its instances' values in
instance order.
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.core.device import DEFAULT_DEVICE
from vpt_tpu_torch.volume.grid import HostGrid


def root_box(host_grids, instance_grid_ids, xforms):
    """(root_pmin, root_pmax) float64: the instances' world boxes' union
    padded by 1, as build_scene's (bvh_builder.cpp:76-78)."""
    from vpt_tpu_torch.scene.scene import _world_bounds
    b = [_world_bounds(host_grids[int(g)], np.asarray(x, np.float64))
         for g, x in zip(instance_grid_ids, xforms)]
    return (np.stack([lo for lo, _ in b]).min(0) - 1.0,
            np.stack([hi for _, hi in b]).max(0) + 1.0)


def world_grid(root_pmin, root_pmax, resolution: int):
    """(cell, dims (3,) int64 x, y, z) of the isotropic world grid whose
    longest axis holds ``resolution`` voxels."""
    extent = np.asarray(root_pmax, np.float64) - root_pmin
    cell = float(extent.max()) / int(resolution)
    return cell, np.maximum(np.ceil(extent / cell).astype(np.int64), 1)


def _waves(lo, hi) -> np.ndarray:
    """Each instance's wave: one past the latest wave of an earlier
    instance whose voxel box [lo, hi] overlaps its own, else 0."""
    wave = np.zeros(len(lo), np.int64)
    for j in range(1, len(lo)):
        ov = np.all((lo[:j] <= hi[j]) & (hi[:j] >= lo[j]), axis=1)
        if ov.any():
            wave[j] = wave[:j][ov].max() + 1
    return wave


def resample_instances(fields, instance_grid_ids, inv_xforms, bmins, pmins,
                       pmaxs, root_pmin, cell: float, dims, device,
                       combine=("sum",)):
    """Each instance's node fields at the world grid's voxel centres
    (root_pmin + (i + 0.5) cell), combined over the instances in order.

    ``fields[g]``: grid g's tuple of (nz, ny, nx) tensors on ``device``
    (None for a channel it lacks); ``combine[c]`` "sum" (zeros before the
    first instance) or "max" (from 0) for channel c.  ``inv_xforms``
    (N, 4, 4) world->index, ``bmins[g]`` grid g's (3,) bbox_min,
    ``pmins`` and ``pmaxs``
    (N, 3) the instance boxes, all float64 numpy.  Returns one (nz, ny,
    nx) float32 tensor a channel, None for a channel no grid has."""
    from vpt_tpu_torch.accel.shadow import _trilinear_index
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    dims = np.asarray(dims, np.int64)
    nx, ny, nz = (int(v) for v in dims)
    gids = np.asarray(instance_grid_ids, np.int64)
    lo = np.clip(np.floor((pmins - root_pmin) / cell).astype(np.int64) - 1,
                 0, dims - 1)
    hi = np.clip(np.ceil((pmaxs - root_pmin) / cell).astype(np.int64) + 1,
                 0, dims - 1)
    n_ch = len(combine)
    outs = [None if all(f[c] is None for f in fields.values()) else
            torch.zeros(nz * ny * nx, dtype=torch.float32, device=dev)
            for c in range(n_ch)]
    inv = torch.as_tensor(np.asarray(inv_xforms, np.float64), **f64)
    root = torch.as_tensor(np.asarray(root_pmin, np.float64), **f64)
    wave = _waves(lo, hi)
    for w in range(int(wave.max()) + 1 if len(wave) else 0):
        for g in np.unique(gids[wave == w]):
            m = np.nonzero((wave == w) & (gids == g))[0]
            ext = (hi[m] - lo[m] + 1).max(0)
            lo_t = torch.as_tensor(lo[m], device=dev)
            hi_t = torch.as_tensor(hi[m], device=dev)
            ax = [lo_t[:, a, None] + torch.arange(int(ext[a]), device=dev)
                  for a in range(3)]
            xx = ax[0][:, None, None, :]
            yy = ax[1][:, None, :, None]
            zz = ax[2][:, :, None, None]
            ok = ((xx <= hi_t[:, 0, None, None, None])
                  & (yy <= hi_t[:, 1, None, None, None])
                  & (zz <= hi_t[:, 2, None, None, None]))
            shape = ok.shape
            wpos = (torch.stack([xx.expand(shape), yy.expand(shape),
                                 zz.expand(shape)], -1).to(torch.float64)
                    + 0.5) * cell + root
            mi = inv[torch.as_tensor(m, device=dev)]
            ipos = (wpos.reshape(len(m), -1, 3) @ mi[:, :3, :3]
                    + mi[:, None, 3, :3]
                    - torch.as_tensor(bmins[g] + 0.5, **f64))
            ipos = ipos.reshape(shape + (3,))[ok]
            flat = ((zz * ny + yy) * nx + xx).expand(shape)[ok]
            for c in range(n_ch):
                field = fields[int(g)][c]
                if field is None:
                    continue
                v = _trilinear_index(field, ipos)
                cur = outs[c][flat]
                outs[c][flat] = (cur + v if combine[c] == "sum"
                                 else torch.maximum(cur, v))
    return [None if o is None else o.reshape(nz, ny, nx) for o in outs]


def resample_union_grid(host_grids, instance_grid_ids, instance_xforms,
                        resolution: int = 256,
                        device=DEFAULT_DEVICE) -> HostGrid:
    """The instanced scene's union fields on one world grid of
    ``resolution`` voxels along the root box's longest axis (isotropic
    voxels), resampled on ``device``: density and emission summed over
    the instances, color their component-wise max
    (vpt_tpu/volume/union.py:45-113)."""
    ids = np.asarray(instance_grid_ids, np.int64)
    xforms = np.stack([np.asarray(x, np.float64) for x in instance_xforms])
    root_pmin, root_pmax = root_box(host_grids, ids, xforms)
    cell, dims = world_grid(root_pmin, root_pmax, resolution)
    from vpt_tpu_torch.scene.scene import _world_bounds
    bounds = [_world_bounds(host_grids[int(g)], x)
              for g, x in zip(ids, xforms)]
    used = sorted(set(int(g) for g in ids))

    def t(a):
        return (None if a is None
                else torch.as_tensor(np.asarray(a, np.float32), device=device))
    fields = {}
    for g in used:
        hg = host_grids[g]
        col = t(hg.color_zyx)
        fields[g] = (t(hg.density_zyx), t(hg.emission_zyx),
                     *((None,) * 3 if col is None
                       else (col[..., c].contiguous() for c in range(3))))
    bmins = {g: np.asarray(host_grids[g].bbox_min, np.float64) for g in used}
    dens, emis, *col = resample_instances(
        fields, ids, np.linalg.inv(xforms), bmins,
        np.stack([b[0] for b in bounds]), np.stack([b[1] for b in bounds]),
        root_pmin, cell, dims, device,
        combine=("sum", "sum", "max", "max", "max"))
    dens = dens.cpu().numpy()
    xf_u = np.diag([cell, cell, cell, 1.0])
    xf_u[3, :3] = root_pmin
    return HostGrid(
        density_zyx=dens,
        emission_zyx=None if emis is None else emis.cpu().numpy(),
        color_zyx=(None if col[0] is None
                   else torch.stack(col, -1).cpu().numpy()),
        bbox_min=np.zeros(3, np.int32), dim=dims.astype(np.int32),
        transform=xf_u, voxel_size=cell, max_density=float(dens.max()),
        min_density=min(host_grids[int(g)].min_density for g in ids))


def exact_density_at(host_grids, instance_grid_ids, instance_xforms, wpos,
                     device=DEFAULT_DEVICE) -> np.ndarray:
    """The exact summed instance density at world points (n, 3), float64
    numpy: each instance whose world box, widened by a voxel, holds a
    point adds its trilinear density there, the points' sums taken in
    instance order (vpt_tpu/volume/union.py:116-140)."""
    from vpt_tpu_torch.accel.shadow import _trilinear_index
    from vpt_tpu_torch.scene.scene import _world_bounds
    ids = np.asarray(instance_grid_ids, np.int64)
    wpos = np.asarray(wpos, np.float64)
    xforms = [np.asarray(x, np.float64) for x in instance_xforms]
    lo, hi, pad = [], [], []
    for g, xf in zip(ids, xforms):
        b = _world_bounds(host_grids[int(g)], xf)
        lo.append(b[0])
        hi.append(b[1])
        pad.append(float(host_grids[int(g)].voxel_size)
                   * float(np.abs(xf[:3, :3]).max()) + 1e-6)
    lo, hi, pad = np.stack(lo), np.stack(hi), np.asarray(pad)[:, None]
    hit = np.all((wpos[:, None, :] >= (lo - pad)[None])
                 & (wpos[:, None, :] <= (hi + pad)[None]), axis=2)
    pts, inst = np.nonzero(hit)  # by point, then instance
    total = np.zeros(len(wpos), np.float64)
    if len(pts) == 0:
        return total
    start = np.searchsorted(pts, pts, side="left")
    rank = np.arange(len(pts)) - start
    inv = np.linalg.inv(np.stack(xforms))
    dev = torch.device(device)
    fields = {}
    for r in range(int(rank.max()) + 1):
        for g in np.unique(ids[inst[rank == r]]):
            sel = np.nonzero((rank == r) & (ids[inst] == g))[0]
            if int(g) not in fields:
                fields[int(g)] = torch.as_tensor(np.asarray(
                    host_grids[int(g)].density_zyx, np.float32), device=dev)
            m = torch.as_tensor(inv[inst[sel]], dtype=torch.float64,
                                device=dev)
            p = torch.as_tensor(wpos[pts[sel]], dtype=torch.float64,
                                device=dev)
            ipos = ((p[:, None, :] @ m[:, :3, :3])[:, 0] + m[:, 3, :3]
                    - torch.as_tensor(np.asarray(
                        host_grids[int(g)].bbox_min, np.float64) + 0.5,
                        dtype=torch.float64, device=dev))
            total[pts[sel]] += _trilinear_index(fields[int(g)],
                                                ipos).cpu().numpy()
    return total


def _sample_points(host_grids, instance_grid_ids, instance_xforms, n, seed):
    """n world points, each uniform in a random instance's world box
    (vpt_tpu/volume/union.py:143-158: numpy's RandomState, so the same
    points)."""
    from vpt_tpu_torch.scene.scene import _world_bounds
    rng = np.random.RandomState(seed)
    ids = np.asarray(instance_grid_ids, np.int64)
    pick = rng.randint(0, len(ids), size=n)
    bounds = [_world_bounds(host_grids[int(g)], np.asarray(x, np.float64))
              for g, x in zip(ids, instance_xforms)]
    pts = np.empty((n, 3), np.float64)
    for i, k in enumerate(pick):
        lo, hi = bounds[k]
        pts[i] = lo + rng.rand(3) * (hi - lo)
    return pts


def union_field_error(union: HostGrid, host_grids, instance_grid_ids,
                      instance_xforms, n: int = 4096, seed: int = 0,
                      device=DEFAULT_DEVICE) -> float:
    """mean |union(p) - exact(p)| / mean exact(p) of a built union grid
    over n points in instance boxes (vpt_tpu/volume/union.py:161-183)."""
    from vpt_tpu_torch.accel.shadow import _trilinear_index
    pts = _sample_points(host_grids, instance_grid_ids, instance_xforms, n,
                         seed)
    exact = exact_density_at(host_grids, instance_grid_ids, instance_xforms,
                             pts, device)
    inv = np.linalg.inv(np.asarray(union.transform, np.float64))
    ipos = (pts @ inv[:3, :3] + inv[3, :3]
            - (np.asarray(union.bbox_min, np.float64) + 0.5))
    approx = _trilinear_index(
        torch.as_tensor(np.asarray(union.density_zyx, np.float32),
                        device=device),
        torch.as_tensor(ipos, dtype=torch.float64, device=device))
    return float(np.abs(approx.cpu().numpy() - exact).mean()
                 / max(float(exact.mean()), 1e-12))


def union_error_at_resolution(host_grids, instance_grid_ids,
                              instance_xforms, resolution: int,
                              n: int = 2048, seed: int = 0,
                              device=DEFAULT_DEVICE) -> float:
    """The union's field error at ``resolution`` without building it:
    its value at p is the trilinear blend of the exact sums at the 8
    union voxel centres around p (vpt_tpu/volume/union.py:186-222)."""
    root_pmin, root_pmax = root_box(host_grids, instance_grid_ids,
                                    instance_xforms)
    cell = float((root_pmax - root_pmin).max()) / int(resolution)
    pts = _sample_points(host_grids, instance_grid_ids, instance_xforms, n,
                         seed)
    exact = exact_density_at(host_grids, instance_grid_ids, instance_xforms,
                             pts, device)
    x = (pts - root_pmin) / cell - 0.5
    i0 = np.floor(x)
    frac = x - i0
    approx = np.zeros(n, np.float64)
    for c in range(8):
        d = np.array([c & 1, (c >> 1) & 1, (c >> 2) & 1], np.float64)
        centers = root_pmin + (i0 + d + 0.5) * cell
        w = np.prod(np.where(d > 0, frac, 1.0 - frac), axis=1)
        approx += w * exact_density_at(host_grids, instance_grid_ids,
                                       instance_xforms, centers, device)
    return float(np.abs(approx - exact).mean()
                 / max(float(exact.mean()), 1e-12))


def choose_union_resolution(host_grids, instance_grid_ids, instance_xforms,
                            error_budget: float = 0.05,
                            candidates=(160, 224, 320, 448, 640),
                            n: int = 2048, seed: int = 0,
                            device=DEFAULT_DEVICE):
    """(the coarsest candidate resolution whose estimated field error is
    within ``error_budget``, that error); the finest candidate and its
    error when none is (vpt_tpu/volume/union.py:225-242)."""
    err = float("inf")
    for res in candidates:
        err = union_error_at_resolution(host_grids, instance_grid_ids,
                                        instance_xforms, res, n=n, seed=seed,
                                        device=device)
        if err <= error_budget:
            return int(res), err
    return int(candidates[-1]), err


def build_union_scene(host_grids, instance_grid_ids, instance_xforms,
                      resolution: int = 256, corner_dtype: str = "bfloat16",
                      octant_boxes: bool | str = "auto",
                      device=DEFAULT_DEVICE, timings: dict | None = None,
                      **build_kw):
    """resample_union_grid, then build_scene on the one grid: the
    instanced scene as a single instance, in bfloat16 rows by default
    (vpt_tpu/volume/union.py:245-268).  ``timings``, where given,
    receives resample_s and build_s."""
    import time

    from vpt_tpu_torch.scene.scene import build_scene
    t0 = time.perf_counter()
    union = resample_union_grid(host_grids, instance_grid_ids,
                                instance_xforms, resolution, device=device)
    t1 = time.perf_counter()
    scene = build_scene([union], corner_dtype=corner_dtype,
                        octant_boxes=octant_boxes, device=device, **build_kw)
    if timings is not None:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        timings.update(resample_s=t1 - t0,
                       build_s=time.perf_counter() - t1)
    return scene
