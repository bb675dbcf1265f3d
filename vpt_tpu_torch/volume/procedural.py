"""Procedural fBm-Perlin volume (port of vpt_tpu/volume/procedural.py:
33-152, 189-236), evaluated in torch on the target device.

The lattice hash is uint32 arithmetic on possibly negative ints; here
it is int64 masked to 32 bits, with the products split into 16-bit
halves so they never leave int64, which reproduces the reference's
wraparound exactly.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vpt_tpu_torch.core.device import DEFAULT_DEVICE
from vpt_tpu_torch.volume.grid import HostGrid

MASK = 0xFFFFFFFF
NOISE_FBM_PERLIN = 3


def _mul32(a, b: int):
    """(a * b) mod 2**32 for int64 a in [0, 2**32) and a 32-bit constant."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _hash3(ix, iy, iz, seed: int):
    """Integer lattice hash -> uint32 (as int64)."""
    h = (_mul32(ix & MASK, 0x8da6b343) + _mul32(iy & MASK, 0xd8163841)
         + _mul32(iz & MASK, 0xcb1ab31f)
         + ((seed & MASK) * 0x9e3779b9 & MASK)) & MASK
    h = h ^ (h >> 13)
    h = _mul32(h, 0x85ebca6b)
    return h ^ (h >> 16)


def _hash_unit(ix, iy, iz, seed: int, salt: int = 0):
    """uniform [0,1) from a lattice point."""
    return _hash3(ix, iy, iz, seed + salt * 101).to(torch.float32) * (
        1.0 / 4294967296.0)


def _gradient(ix, iy, iz, seed):
    u1 = _hash_unit(ix, iy, iz, seed, 1)
    u2 = _hash_unit(ix, iy, iz, seed, 2)
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2
    return r * torch.cos(phi), r * torch.sin(phi), z


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin(pos, scale, seed: int):
    """Classic gradient noise; ``scale`` is a float32 0-d tensor."""
    p = pos * scale
    pi = torch.floor(p)
    pf = p - pi
    ix, iy, iz = (pi[..., k].to(torch.int64) for k in range(3))

    def dot_grad(ox, oy, oz):
        gx, gy, gz = _gradient(ix + ox, iy + oy, iz + oz, seed)
        return (gx * (pf[..., 0] - ox) + gy * (pf[..., 1] - oy)
                + gz * (pf[..., 2] - oz))

    u, v, w = _fade(pf[..., 0]), _fade(pf[..., 1]), _fade(pf[..., 2])

    def lerp(a, b, t):
        return a + (b - a) * t

    x00 = lerp(dot_grad(0, 0, 0), dot_grad(1, 0, 0), u)
    x10 = lerp(dot_grad(0, 1, 0), dot_grad(1, 1, 0), u)
    x01 = lerp(dot_grad(0, 0, 1), dot_grad(1, 0, 1), u)
    x11 = lerp(dot_grad(0, 1, 1), dot_grad(1, 1, 1), u)
    return lerp(lerp(x00, x10, v), lerp(x01, x11, v), w)


def fbm(pos, scale, seed: int, octaves=8, lacunarity=1.9, gain=0.5):
    """repeaterPerlin (texture_kernels.cu:104-109).  The frequency is
    carried in float32, as in the reference."""
    acc = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    amp = 1.0
    freq = scale
    for o in range(octaves):
        acc = acc + amp * perlin(pos, freq, seed + o * 7)
        amp *= gain
        freq = freq * lacunarity
    return acc


def create_procedural_grid(vmin=(-100.0, -100.0, -100.0),
                           vmax=(100.0, 100.0, 100.0), res=1.0,
                           noise_type: int = NOISE_FBM_PERLIN,
                           scale: float = 0.01, seed: int = 123,
                           chunk_z: int = 0,
                           device=DEFAULT_DEVICE) -> HostGrid:
    """GPU_PROC_VOL::create_volume (gpu_vdb.cpp:508-609): an fBm-filled
    dense grid over [vmin, vmax] at voxel size ``res``; negative noise
    clamps to 0.  ``chunk_z`` > 0 evaluates z-slabs of that many slices
    to bound device memory.  The noise runs on ``device``; the grid
    comes back to the host as a HostGrid for the packers."""
    if noise_type != NOISE_FBM_PERLIN:
        raise NotImplementedError("only the fBm-Perlin fill is ported")
    vmin = np.asarray(vmin, np.float64)
    vmax = np.asarray(vmax, np.float64)
    dims = np.maximum(((vmax - vmin) / res).astype(int), 1)
    nx, ny, nz = int(dims[0]), int(dims[1]), int(dims[2])
    scale_t = torch.tensor(scale, dtype=torch.float32, device=device)

    def slab(z0, z1):
        zz, yy, xx = torch.meshgrid(torch.arange(z0, z1, device=device),
                                    torch.arange(ny, device=device),
                                    torch.arange(nx, device=device),
                                    indexing="ij")
        pos = torch.stack([xx, yy, zz], dim=-1).to(torch.float32) + 0.5
        vals = fbm(pos, scale_t, seed)
        return torch.clamp(vals, min=0.0).cpu().numpy()

    step = chunk_z if 0 < chunk_z < nz else nz
    dens = np.empty((nz, ny, nx), np.float32)
    for z0 in range(0, nz, step):
        dens[z0:min(z0 + step, nz)] = slab(z0, min(z0 + step, nz))
    max_d = float(dens.max()) if dens.size else 0.0
    if max_d <= 0.0:
        dens[nz // 2, ny // 2, nx // 2] = 1.0  # avoid a fully empty scene
        max_d = 1.0
    xform = np.diag([res, res, res, 1.0])
    xform[3, :3] = vmin
    return HostGrid(
        density_zyx=dens, emission_zyx=None, color_zyx=None,
        bbox_min=np.zeros(3, np.int32), dim=np.array([nx, ny, nz], np.int32),
        transform=xform, voxel_size=float(res), max_density=max_d,
        min_density=float(np.maximum(dens, np.finfo(np.float32).eps).min()))


def default_procedural_grid(device=DEFAULT_DEVICE) -> HostGrid:
    """The reference's no-asset demo volume (main.cpp:1281-1297): a
    [-100,100]^3 box at voxel size 1."""
    return create_procedural_grid(device=device)
