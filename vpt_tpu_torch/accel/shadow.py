"""Precomputed light optical depths ("taus"), baked into the rows a walk
step reads (port of vpt_tpu/accel/shadow.py:36-541).

A medium event reads its NEE transmittances from the same row fetch
that produced the collision density: the corner rows of a single
instance, or, on an instanced scene with cell lists, the majorant cell
rows, whose (R+1)^3 corner lattice takes taus swept on a world grid of
the summed instance density (``_fold_cell_taus``).  An instanced scene
without lists keeps that world grid's corner-packed taus as a table of
its own, ``Scene.world_tau``, read with one more row load at the event
(``world_tau_fetch``).  The bakes run in torch on the
scene's device: at 200^3 the directional sweep is ~700 eight-tap
passes over 8 M voxels and the point-light resample ~48 M trilinear
samples, which the reference ran in numpy on the host.  float64 is
used where the reference's numpy code computes in float64.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from vpt_tpu_torch.core.vecmath import degree_to_cartesian
from vpt_tpu_torch.volume.grid import _corner_pack_plain, unified_layout

MAX_CACHED_LIGHTS = 8


def _trilinear_index(field, ipos):
    """Trilinear sample of a zyx node field at float64 node coordinates
    (node i at coordinate i); zero outside the [0, n-1] support.  The
    sum is rounded to float32 after each tap, as numpy's in-place
    ``out += v * w`` on a float32 array does."""
    nz, ny, nx = field.shape
    x, y, z = ipos[..., 0], ipos[..., 1], ipos[..., 2]
    inb = ((x > -1.0) & (x < nx) & (y > -1.0) & (y < ny)
           & (z > -1.0) & (z < nz))
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0, y - y0, z - z0
    flat = field.reshape(-1)
    out = torch.zeros(ipos.shape[:-1], dtype=torch.float32,
                      device=field.device)
    for c in range(8):
        dx, dy, dz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        xi = (x0 + dx).to(torch.int64)
        yi = (y0 + dy).to(torch.int64)
        zi = (z0 + dz).to(torch.int64)
        ok = ((xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
              & (zi >= 0) & (zi < nz))
        v = flat[(torch.clamp(zi, 0, nz - 1) * ny
                  + torch.clamp(yi, 0, ny - 1)) * nx
                 + torch.clamp(xi, 0, nx - 1)]
        v = torch.where(ok, v, 0.0).to(torch.float64)
        w = ((fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)
             * (fz if dz else 1.0 - fz))
        out = (out.to(torch.float64) + v * w).to(torch.float32)
    return torch.where(inb, out, 0.0)


def _shift3(a, sz, sy, sx):
    """a[z+sz, y+sy, x+sx] with zero fill (a is zyx)."""
    nz, ny, nx = a.shape
    out = torch.zeros_like(a)
    z0, z1 = max(0, -sz), min(nz, nz - sz)
    y0, y1 = max(0, -sy), min(ny, ny - sy)
    x0, x1 = max(0, -sx), min(nx, nx - sx)
    if z0 >= z1 or y0 >= y1 or x0 >= x1:
        return out
    out[z0:z1, y0:y1, x0:x1] = a[z0 + sz:z1 + sz, y0 + sy:y1 + sy,
                                 x0 + sx:x1 + sx]
    return out


def directional_tau_nodes(density_zyx, dir_idx: np.ndarray,
                          world_per_idx: float, step_vox: float = 0.5):
    """tau(node) = integral of density from each node to the grid exit
    along a constant direction (the sun): midpoint quadrature in
    ``step_vox``-voxel steps, each a constant-offset trilinear shift of
    the whole field (vpt_tpu/accel/shadow.py:74-111)."""
    nz, ny, nx = density_zyx.shape
    u = dir_idx / max(np.linalg.norm(dir_idx), 1e-12)
    h_world = step_vox * world_per_idx
    K = int(np.ceil(np.linalg.norm([nx, ny, nz]) / step_vox)) + 1
    tau = torch.zeros_like(density_zyx)
    for k in range(K):
        o = (k + 0.5) * step_vox * u
        m = np.floor(o).astype(np.int64)
        f = (o - m).astype(np.float32)
        acc = torch.zeros_like(tau)
        for c in range(8):
            dx, dy, dz = c & 1, (c >> 1) & 1, (c >> 2) & 1
            w = ((f[0] if dx else 1 - f[0]) * (f[1] if dy else 1 - f[1])
                 * (f[2] if dz else 1 - f[2]))
            if w == 0.0:
                continue
            acc += float(w) * _shift3(density_zyx, int(m[2] + dz),
                                      int(m[1] + dy), int(m[0] + dx))
        tau += acc
    return tau * float(np.float32(h_world))


def _sph_angles(u):
    th = torch.arccos(torch.clamp(u[..., 2], -1.0, 1.0))
    ph = torch.remainder(torch.arctan2(u[..., 1], u[..., 0]), 2 * math.pi)
    return th, ph


def _sph_cells(u, n_theta, n_phi):
    th, ph = _sph_angles(u)
    ti = th / math.pi * n_theta - 0.5
    pi_ = ph / (2 * math.pi) * n_phi - 0.5
    t0 = torch.clamp(torch.floor(ti), 0, n_theta - 1).to(torch.int64)
    t1 = torch.clamp(t0 + 1, max=n_theta - 1)
    ft = torch.clamp(ti - t0, 0.0, 1.0)
    p0 = torch.remainder(torch.floor(pi_).to(torch.int64), n_phi)
    p1 = (p0 + 1) % n_phi
    fp = torch.clamp(pi_ - torch.floor(pi_), 0.0, 1.0)
    return t0, t1, ft, p0, p1, fp


def _sph_lerp(F, u, r_frac):
    """Trilinear (theta, wrapped phi, r) interpolation of F at direction
    u and radius index r_frac (F has an implicit r=0 plane at index 0)."""
    n_theta, n_phi, n_r1 = F.shape
    t0, t1, ft, p0, p1, fp = _sph_cells(u, n_theta, n_phi)
    ri = torch.clamp(r_frac, 0.0, n_r1 - 1.0)
    r0 = torch.floor(ri).to(torch.int64)
    r1 = torch.clamp(r0 + 1, max=n_r1 - 1)
    fr = ri - r0
    flat = F.reshape(-1)
    out = 0.0
    for tt, wt in ((t0, 1 - ft), (t1, ft)):
        for pp, wp in ((p0, 1 - fp), (p1, fp)):
            for rr, wr in ((r0, 1 - fr), (r1, fr)):
                out = out + flat[(tt * n_phi + pp) * n_r1 + rr] * (
                    wt * wp * wr)
    return out


def _sph_lerp_total(F_tot, u):
    n_theta, n_phi = F_tot.shape
    t0, t1, ft, p0, p1, fp = _sph_cells(u, n_theta, n_phi)
    return (F_tot[t0, p0] * (1 - ft) * (1 - fp)
            + F_tot[t1, p0] * ft * (1 - fp)
            + F_tot[t0, p1] * (1 - ft) * fp
            + F_tot[t1, p1] * ft * fp)


def point_tau_nodes(density_zyx, xform: np.ndarray, bbox_min, light_world,
                    n_theta: int = 180, n_phi: int = 360,
                    step_world: float | None = None,
                    node_chunk: int = 1 << 21):
    """tau(node) = integral of density from each node THROUGH the point
    light to the grid exit (vpt_tpu/accel/shadow.py:128-204): resample
    the density on a spherical grid around the light, cumulate radially
    to F(theta, phi, r), then tau = F(dir, r(node)) + F(-dir, R_max)."""
    dev = density_zyx.device
    f64 = dict(dtype=torch.float64, device=dev)
    nz, ny, nx = density_zyx.shape
    light_world = np.asarray(light_world, np.float64)
    corners_idx = np.array([[x, y, z] for x in (0, nx) for y in (0, ny)
                            for z in (0, nz)], np.float64)
    corners_idx += np.asarray(bbox_min, np.float64) - 0.5
    corners_w = corners_idx @ xform[:3, :3] + xform[3, :3]
    r_max = float(np.max(np.linalg.norm(corners_w - light_world, axis=-1)))
    r_max = max(r_max, 1e-6)
    if step_world is None:
        step_world = 0.5 * float(np.linalg.norm(xform[:3, :3], axis=1).min())
    n_r = max(int(np.ceil(r_max / step_world)), 2)

    theta = (torch.arange(n_theta, **f64) + 0.5) / n_theta * math.pi
    phi = (torch.arange(n_phi, **f64) + 0.5) / n_phi * (2 * math.pi)
    rr = (torch.arange(n_r, **f64) + 0.5) * step_world
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    dirs = torch.stack([st[:, None] * cp[None, :], st[:, None] * sp[None, :],
                        ct[:, None].expand(n_theta, n_phi)], dim=-1)
    inv = torch.as_tensor(np.linalg.inv(np.asarray(xform, np.float64)),
                          **f64)
    shift = torch.as_tensor(np.asarray(bbox_min, np.float64) + 0.5, **f64)
    lw = torch.as_tensor(light_world, **f64)

    F = torch.zeros((n_theta, n_phi, n_r + 1), dtype=torch.float32,
                    device=dev)
    chunk = max(1, int(2e7 // (n_theta * n_phi)))
    acc = torch.zeros((n_theta, n_phi), dtype=torch.float32, device=dev)
    for r0 in range(0, n_r, chunk):
        r1 = min(r0 + chunk, n_r)
        pts = lw + dirs[:, :, None, :] * rr[None, None, r0:r1, None]
        ipos = (pts.reshape(-1, 3) @ inv[:3, :3] + inv[3, :3]
                - shift).reshape(n_theta, n_phi, r1 - r0, 3)
        sig = _trilinear_index(density_zyx, ipos)
        seg = torch.cumsum(sig.to(torch.float64), dim=-1) * step_world
        F[:, :, r0 + 1:r1 + 1] = (acc[..., None].to(torch.float64)
                                  + seg).to(torch.float32)
        acc = (acc.to(torch.float64) + seg[..., -1].to(torch.float32)
               .to(torch.float64)).to(torch.float32)
    F_tot = F[:, :, -1]

    xf = torch.as_tensor(np.asarray(xform, np.float64), **f64)
    bmin = torch.as_tensor(np.asarray(bbox_min, np.float64) + 0.5, **f64)
    out = torch.empty(nz * ny * nx, dtype=torch.float32, device=dev)
    for s in range(0, nz * ny * nx, node_chunk):
        idx = torch.arange(s, min(s + node_chunk, nz * ny * nx),
                           device=dev)
        node = torch.stack([idx % nx, (idx // nx) % ny, idx // (nx * ny)],
                           dim=-1).to(torch.float64) + bmin
        node_w = node @ xf[:3, :3] + xf[3, :3]
        rel = node_w - lw
        r = torch.linalg.norm(rel, dim=-1)
        u = rel / torch.clamp(r, min=1e-12)[..., None]
        tau_in = _sph_lerp(F, u, r / step_world)
        tau_out = _sph_lerp_total(F_tot, -u)
        out[s:s + idx.numel()] = (tau_in + tau_out).to(torch.float32)
    return out.reshape(nz, ny, nx)


def n_cached_lights(atlas) -> int:
    """Count of cached point-light tau channels (-1: no cache)."""
    w = atlas.density_corners.shape[1]
    base = unified_layout(atlas)[2]
    if w <= base:
        return -1
    return (w - base) // 8 - 1


def _downsample2(a):
    """2x average pool (edge-padded to even dims)."""
    nz, ny, nx = a.shape
    pz, py, px = nz % 2, ny % 2, nx % 2
    if pz or py or px:
        a = torch.nn.functional.pad(a[None, None], (0, px, 0, py, 0, pz),
                                    mode="replicate")[0, 0]
    return a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2,
                     a.shape[2] // 2, 2).mean(dim=(1, 3, 5))


def _upsample_tau(field, shape, s: float):
    """Trilinear upsample of an s-x pooled voxel-centre field back to the
    full-resolution centres: full centre j maps to (j - (s-1)/2) / s."""
    nz, ny, nx = shape
    dev = field.device
    zz, yy, xx = torch.meshgrid(
        *(torch.arange(n, dtype=torch.float64, device=dev)
          for n in (nz, ny, nx)), indexing="ij")
    ipos = (torch.stack([xx, yy, zz], dim=-1) - (s - 1.0) / 2.0) / s
    return _trilinear_index(field, ipos)


def _union_density_from_scene(scene, resolution: int):
    """The scene's summed instance density resampled onto a world grid
    over the root box, in instance order, on the scene's device
    (vpt_tpu/accel/shadow.py:402-451; volume/union.py::
    resample_instances).  Returns (density (nz, ny, nx), cell (float),
    root_pmin (3,) float64)."""
    from vpt_tpu_torch.volume.union import resample_instances, world_grid
    atlas = scene.atlas
    root_pmin = scene.root_pmin.cpu().double().numpy()
    cell, dims = world_grid(root_pmin, scene.root_pmax.cpu().double().numpy(),
                            resolution)
    gids = scene.instances.grid_id.cpu().numpy()
    offs = atlas.offset.cpu().numpy()
    gdims = atlas.dim.cpu().numpy()
    fields = {}
    for g in set(int(v) for v in gids):
        gx, gy, gz = (int(v) for v in gdims[g])
        fields[g] = (atlas.density[int(offs[g]):int(offs[g]) + gx * gy * gz]
                     .reshape(gz, gy, gx),)
    (dens,) = resample_instances(
        fields, gids, scene.instances.inv_xform.cpu().double().numpy(),
        atlas.bmin.cpu().double().numpy(),
        scene.instances.pmin.cpu().double().numpy(),
        scene.instances.pmax.cpu().double().numpy(), root_pmin, cell, dims,
        scene.device)
    return dens, cell, root_pmin


def _fold_cell_taus(scene, tau_fields, cell_t: float, root_t):
    """Append 8 (1 + L) tau corner columns to MajorantGrid.cell_rows:
    each node field (voxel centres at root_t + (i + 0.5) cell_t) sampled
    at the cell grid's (R+1)^3 corner lattice and packed per cell in tap
    order c = x + 2y + 4z (vpt_tpu/accel/shadow.py:502-533).  A prior
    bake's columns are replaced."""
    major = scene.majorant
    R = major.resolution
    dev = scene.device
    f64 = dict(dtype=torch.float64, device=dev)
    root_pmin = scene.root_pmin.cpu().double().numpy()
    cs = (scene.root_pmax.cpu().double().numpy() - root_pmin) / R
    ax = [torch.arange(R + 1, **f64) * float(cs[a]) + float(root_pmin[a])
          for a in range(3)]
    gz, gy, gx = torch.meshgrid(ax[2], ax[1], ax[0], indexing="ij")
    fidx = (torch.stack([gx, gy, gz], dim=-1)
            - torch.as_tensor(np.asarray(root_t, np.float64), **f64)) \
        / cell_t - 0.5
    packs = []
    for field in tau_fields:
        nodes = _trilinear_index(field, fidx)
        packs.append(torch.stack(
            [nodes[c >> 2:(c >> 2) + R, (c >> 1) & 1:((c >> 1) & 1) + R,
                   c & 1:(c & 1) + R].reshape(-1) for c in range(8)], dim=1))
    base = major.packed.shape[-1] + major.cell_instances.shape[-1]
    rows = torch.cat([major.cell_rows[:, :base]] + packs, dim=1).contiguous()
    return dataclasses.replace(
        scene, majorant=dataclasses.replace(major, cell_rows=rows),
        world_tau=None)


def _attach_world_shadow_cache(scene, azimuth, elevation, step_vox,
                               resolution):
    """attach_shadow_cache on an instanced scene: sweep the sun and
    point-light taus over the union density on a ``resolution`` world
    grid, then fold them into the cell rows, or, without cell lists, keep
    them as the world tau grid (vpt_tpu/accel/shadow.py:454-499)."""
    from vpt_tpu_torch.render.tracking import _use_cells
    dens, cell, root_pmin = _union_density_from_scene(scene, resolution)
    sun_dir = degree_to_cartesian(azimuth, elevation).double().numpy()
    tau_fields = [directional_tau_nodes(dens, sun_dir, cell,
                                        step_vox=step_vox)]
    xf = np.diag([cell, cell, cell, 1.0])
    xf[3, :3] = root_pmin
    for lp in scene.lights.pos.cpu().double().numpy():
        tau_fields.append(point_tau_nodes(dens, xf, np.zeros(3), lp))
    if _use_cells(scene):
        return _fold_cell_taus(scene, tau_fields, cell, root_pmin)
    nz, ny, nx = dens.shape
    rows = torch.cat([_corner_pack_plain(t) for t in tau_fields], dim=1)
    return dataclasses.replace(
        scene, world_tau=rows.reshape(nz, ny, nx, -1).contiguous())


def world_tau_cell(scene):
    """The world tau grid's cell as its fetch computes it: the root box's
    largest extent over the grid's largest dimension, one float32
    division (a 0-d tensor on the scene's device)."""
    nz, ny, nx = scene.world_tau.shape[:3]
    extent = scene.root_pmax - scene.root_pmin
    return torch.amax(extent) / torch.tensor(float(max(nx, ny, nz)),
                                             device=extent.device)


def world_tau_fetch(scene, pos):
    """(..., 1 + L) cached optical depths at world ``pos`` from the world
    tau grid: one corner row and its trilinear weights
    (vpt_tpu/accel/shadow.py:562-586)."""
    from vpt_tpu_torch.render.tracking import _trilerp_weights, _wsum8
    wt = scene.world_tau
    nz, ny, nx, w = wt.shape
    dimf = torch.tensor([nx, ny, nz], dtype=torch.float32, device=wt.device)
    x = (pos - scene.root_pmin) / world_tau_cell(scene) - 0.5
    x = torch.minimum(torch.clamp(x, min=0.0), dimf - 1.0)
    i0f = torch.floor(x)
    i0 = i0f.to(torch.int64)
    rows = wt.reshape(-1, w)[(i0[..., 2] * ny + i0[..., 1]) * nx
                             + i0[..., 0]]
    w8 = _trilerp_weights(x - i0f)
    return torch.stack([_wsum8(rows[..., 8 * c:8 * c + 8], w8)
                        for c in range(w // 8)], dim=-1)


def cell_tau_fetch(scene, pos):
    """(..., 1 + L) cached optical depths from the tau columns of the
    cell rows at world ``pos`` (the walk reads them from the row it
    fetched, render/tracking.py::_cells_banded_fetch)."""
    from vpt_tpu_torch.render.tracking import (_cell_coords, _cell_taus,
                                               cell_layout)
    _, rel, ci, flat = _cell_coords(scene, pos)
    ids_off, k, n_ch = cell_layout(scene)
    return _cell_taus(scene.majorant.cell_rows[flat], rel, ci, ids_off + k,
                      n_ch)


def cached_light_channels(scene) -> int:
    """Point-light channels of a scene's shadow cache, from the rows a
    walk step reads (-1: no cache)."""
    if scene.majorant is not None and scene.majorant.cell_rows is not None:
        from vpt_tpu_torch.render.tracking import cell_layout
        n_ch = cell_layout(scene)[2]
        return n_ch - 1 if n_ch else -1
    if scene.instances.count != 1:
        return (-1 if scene.world_tau is None
                else scene.world_tau.shape[-1] // 8 - 1)
    return n_cached_lights(scene.atlas)


def attach_shadow_cache(scene, azimuth: float, elevation: float,
                        step_vox: float = 0.5,
                        world_resolution: int = 192,
                        tau_downsample: int | None = None):
    """Bake sun + point-light optical depths into the corner rows: 8 (1 +
    L) columns after unified_layout's tau offset, in the rows' dtype
    (float32 or bfloat16, rounded to nearest, as vpt_tpu/accel/shadow.py:
    393-396).  Render with ``shadow_mode="cached"`` at the same
    azimuth/elevation.

    ``tau_downsample`` None = auto: 1 below 32 M voxels; at and above,
    the bake runs on a 2x pooled proxy with 240x480 angular cells and
    2-voxel radial steps (the layout of the reference's point-light
    bias fix).  An instanced scene bakes on a ``world_resolution`` grid
    over its root box instead, into its cell rows or, without cell lists,
    into ``Scene.world_tau``."""
    n_lights = int(scene.lights.count)
    if n_lights > MAX_CACHED_LIGHTS:
        raise ValueError(f"shadow cache supports <= {MAX_CACHED_LIGHTS} "
                         f"point lights (scene has {n_lights})")
    if scene.instances.count != 1:
        return _attach_world_shadow_cache(scene, azimuth, elevation,
                                          step_vox, world_resolution)
    atlas = scene.atlas
    nx, ny, nz = (int(v) for v in atlas.dim[0].tolist())
    if atlas.density.shape[0] < nx * ny * nz:
        raise ValueError("shadow cache bake needs the raw density atlas")
    dens = atlas.density[:nx * ny * nz].reshape(nz, ny, nx)
    if tau_downsample is None:
        tau_downsample = 2 if dens.numel() >= 32 * 2 ** 20 else 1
    ds = max(int(tau_downsample), 1)
    big = ds > 1
    dens_p = dens
    vox_scale = 1.0
    while vox_scale * 2 <= ds:
        dens_p = _downsample2(dens_p)
        vox_scale *= 2.0

    xform = scene.instances.xform[0].cpu().double().numpy()
    inv = scene.instances.inv_xform[0].cpu().double().numpy()
    bmin = atlas.bmin[0].cpu().numpy()

    sun_dir = degree_to_cartesian(azimuth, elevation).double().numpy()
    dir_idx = sun_dir @ inv[:3, :3]
    world_per_idx = vox_scale / max(np.linalg.norm(dir_idx), 1e-12)
    tau_sun = directional_tau_nodes(dens_p, dir_idx, world_per_idx,
                                    step_vox=step_vox)
    if vox_scale > 1.0:
        tau_sun = _upsample_tau(tau_sun, (nz, ny, nx), vox_scale)
    dtype = atlas.density_corners.dtype
    channels = [_corner_pack_plain(tau_sun).to(dtype)]

    xform_p = xform.copy()
    if vox_scale > 1.0:
        xform_p[:3, :3] = xform[:3, :3] * vox_scale
    bmin_p = (np.asarray(bmin, np.float64) / vox_scale if vox_scale > 1.0
              else bmin)
    pt_kw = {}
    if big:
        vox_w = float(np.linalg.norm(xform_p[:3, :3], axis=1).min())
        pt_kw = dict(n_theta=240, n_phi=480, step_world=2.0 * vox_w)
    lpos = scene.lights.pos.cpu().double().numpy()
    for i in range(n_lights):
        tau_l = point_tau_nodes(dens_p, xform_p, bmin_p, lpos[i], **pt_kw)
        if vox_scale > 1.0:
            tau_l = _upsample_tau(tau_l, (nz, ny, nx), vox_scale)
        channels.append(_corner_pack_plain(tau_l).to(dtype))

    base = atlas.density_corners[:, :unified_layout(atlas)[2]]
    rows = torch.cat([base] + channels, dim=1).contiguous()
    return dataclasses.replace(
        scene, atlas=dataclasses.replace(atlas, density_corners=rows))
