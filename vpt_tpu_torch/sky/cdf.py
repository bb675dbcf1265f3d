"""Environment importance sampling: the 2-D CDF tables and their
samplers (port of vpt_tpu/sky/cdf.py).

The tables are built on the host's arithmetic of the reference, step for
step: |value| as sqrt((r*r + g*g) + b*b), and every prefix sum in the
order XLA's CPU backend takes for ``jnp.cumsum`` (``_xla_cumsum``), so a
table built from the same value grid is the reference's bit for bit.
The map's 180 x 180 resample (``resize_linear``) is ``jax.image.resize``'s
antialiased triangle filter, its weights computed as the reference
computes them; its sums run in torch's order, which may round otherwise.

``sample_env_cdf`` and ``pdf_env_cdf`` are the plain versions of the sky
next-event estimate's CDF strategy in kernel K5 (csrc/walk.cu), which
repeats them per ray: the two binary searches, the interpolations and the
y-up direction (QUIRKS #10/#19: one resolution, elevation = acos(y)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from vpt_tpu_torch.core.vecmath import true_div, true_sqrt

CDF_RES = 180  # main.cpp:664
_SCAN_BASE = 16  # the block length of XLA's rewritten cumulative sums


@dataclass(frozen=True)
class EnvCDF:
    value: torch.Tensor          # (H, W, 3) radiance
    func: torch.Tensor           # (H, W) |value|
    cdf: torch.Tensor            # (H, W) row-wise conditional CDF
    marginal_func: torch.Tensor  # (H,)
    marginal_cdf: torch.Tensor   # (H,)
    marginal_int: torch.Tensor   # ()

    def to(self, device) -> "EnvCDF":
        return EnvCDF(*(getattr(self, f).to(device) for f in (
            "value", "func", "cdf", "marginal_func", "marginal_cdf",
            "marginal_int")))


def _sequential_cumsum(x):
    """Inclusive prefix sums along the last axis, one float32 add at a
    time from the left (torch.cumsum accumulates in double on the CPU)."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


def _xla_cumsum(x):
    """``jnp.cumsum`` along the last axis as XLA's CPU backend sums it:
    blocks of 16 summed from the left, each block then offset by the
    exclusive prefix of the block totals, themselves scanned the same
    way."""
    n = x.shape[-1]
    if n <= _SCAN_BASE:
        return _sequential_cumsum(x)
    pad = (-n) % _SCAN_BASE
    xp = torch.nn.functional.pad(x, (0, pad))
    inner = _sequential_cumsum(xp.reshape(x.shape[:-1] + (-1, _SCAN_BASE)))
    totals = _xla_cumsum(inner[..., -1])
    excl = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]],
                     dim=-1)
    out = inner + excl[..., None]
    return out.reshape(x.shape[:-1] + (-1,))[..., :n]


def _norm3(v):
    return true_sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
                     + v[..., 2] * v[..., 2])


def build_env_cdf(value_grid) -> EnvCDF:
    """CDF tables of an (H, W, 3) radiance grid, row v at elevation
    v / (H - 1) pi, column u at azimuth u / (W - 1) 2 pi, with the
    reference's off-by-one shifts (main.cpp:685-756): cdf[x] accumulates
    func[x-1] / W, so cdf[0] = 0, and the last column is forced to 1.
    |value| takes a correctly rounded root, where XLA's CPU root may
    differ in the last bit."""
    value_grid = value_grid.to(torch.float32)
    return env_cdf_tables(value_grid, _norm3(value_grid))


def env_cdf_tables(value_grid, func) -> EnvCDF:
    """build_env_cdf's tables from the grid's (H, W) |value|."""
    n_v, n_u = func.shape
    csum = true_div(_xla_cumsum(func), n_u)
    cdf = torch.cat([torch.zeros((n_v, 1), dtype=torch.float32,
                                 device=func.device), csum[:, :-1]], dim=1)
    marginal_func = csum[:, -1]
    cdf = cdf / torch.clamp(marginal_func, min=1e-12)[:, None]
    cdf[:, -1] = 1.0

    mcsum = true_div(_xla_cumsum(marginal_func), n_v)
    marginal_cdf = torch.cat([torch.zeros((1,), dtype=torch.float32,
                                          device=func.device), mcsum[:-1]])
    marginal_int = mcsum[-1]
    marginal_cdf = marginal_cdf / torch.clamp(marginal_int, min=1e-6)
    marginal_cdf[-1] = 1.0
    return EnvCDF(value_grid, func, cdf.contiguous(), marginal_func,
                  marginal_cdf, marginal_int)


def build_sky_cdf(azimuth, elevation, sky_color, res: int = CDF_RES,
                  device=None) -> EnvCDF:
    """The simple sky's CDF (create_cdf, main.cpp:647-771): the sky on a
    res x res (elevation, azimuth) grid."""
    from vpt_tpu_torch.sky.procedural import sample_sky
    a = torch.arange(res, dtype=torch.float32, device=device)
    el = true_div(a, res - 1) * math.pi
    az = true_div(a, res - 1) * 2.0 * math.pi
    el_g, az_g = torch.meshgrid(el, az, indexing="ij")
    dirs = torch.stack([torch.sin(el_g) * torch.cos(az_g), torch.cos(el_g),
                        torch.sin(el_g) * torch.sin(az_g)], dim=-1)
    color = torch.as_tensor(sky_color, dtype=torch.float32,
                            device=device).expand(3)
    return build_env_cdf(sample_sky(dirs, azimuth, elevation, color))


def _weight_mat(n_in: int, n_out: int, device):
    """jax/_src/image/scale.py::compute_weight_mat for the triangle
    kernel with antialiasing, scale n_out / n_in, no translation:
    (n_in, n_out) float32."""
    inv_scale = 1.0 / (n_out / n_in)     # a double, float32 at its use
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=torch.float32)
    sample_f = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale
                - 0.0 * inv_scale - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(
        n_in, dtype=torch.float32)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(torch.finfo(
        torch.float32).eps), w / torch.where(total != 0, total, 1.0), 0.0)
    w = torch.where(((sample_f >= -0.5) & (sample_f <= n_in - 0.5))[None, :],
                    w, 0.0)
    return w.to(device)


def resize_linear(image, height: int, width: int):
    """``jax.image.resize(image, (height, width, C), "linear")`` of an
    (H, W, C) float32 image: separable triangle weights, antialiased
    where the image shrinks; an axis of equal size is left as it is."""
    out = image.to(torch.float32)
    if out.shape[0] != height:
        w0 = _weight_mat(out.shape[0], height, out.device)
        out = torch.einsum("hwc,ho->owc", out, w0)
    if out.shape[1] != width:
        w1 = _weight_mat(out.shape[1], width, out.device)
        out = torch.einsum("hwc,wo->hoc", out, w1)
    return out


def build_envmap_cdf(env_map, res: int | None = CDF_RES) -> EnvCDF:
    """The CDF of an equirect map (an extension: the reference
    importance-samples only the procedural sky), resampled to res x res,
    or at the map's own resolution with ``res`` None."""
    env = torch.as_tensor(env_map, dtype=torch.float32)
    if res is None:
        return build_env_cdf(env)
    return build_env_cdf(resize_linear(env, res, res))


def _interp1(table, x):
    """Linear interpolation of a 1-D table at fractional index x."""
    n = table.shape[0]
    x = torch.clamp(x, 0.0, n - 1.0)
    i0 = torch.floor(x).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    f = x - i0.to(torch.float32)
    return table[i0] * (1.0 - f) + table[i1] * f


def _interp_rows(table2d, rows, x):
    n = table2d.shape[1]
    x = torch.clamp(x, 0.0, n - 1.0)
    i0 = torch.floor(x).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    f = x - i0.to(torch.float32)
    return table2d[rows, i0] * (1.0 - f) + table2d[rows, i1] * f


def sample_env_cdf(env: EnvCDF, u1, u2):
    """Directions drawn from the 2-D CDF (render_kernel.cu:165-252) for
    (...,) uniforms u1 (the row) and u2 (the column): (wo (..., 3), pdf
    (...,))."""
    n_v, n_u = env.cdf.shape
    v = torch.clamp(torch.searchsorted(env.marginal_cdf, u1.contiguous(),
                                       right=True) - 1, 0, n_v - 2)
    m0 = env.marginal_cdf[v]
    d_m = env.marginal_cdf[v + 1] - m0
    dv = torch.where(d_m > 0.0, (u1 - m0) / torch.clamp(d_m, min=1e-20),
                     0.0)
    vf = v.to(torch.float32) + dv
    marginal_pdf = _interp1(env.marginal_func, vf) / torch.clamp(
        env.marginal_int, min=1e-12)
    theta = true_div(vf, n_v) * math.pi

    rows = env.cdf[v]
    u = torch.clamp(torch.searchsorted(rows, u2.contiguous()[..., None],
                                       right=True)[..., 0] - 1, 0, n_u - 2)
    c0 = env.cdf[v, u]
    d_c = env.cdf[v, u + 1] - c0
    du = torch.where(d_c > 0.0, (u2 - c0) / torch.clamp(d_c, min=1e-20),
                     0.0)
    uf = u.to(torch.float32) + du
    cond_pdf = _interp_rows(env.func, v, uf) / torch.clamp(
        env.marginal_func[v], min=1e-12)
    phi = true_div(uf, n_u) * 2.0 * math.pi

    sin_t = torch.sin(theta)
    wo = torch.stack([sin_t * torch.cos(phi), torch.cos(theta),
                      sin_t * torch.sin(phi)], dim=-1)
    pdf = (marginal_pdf * cond_pdf) / (2.0 * math.pi * math.pi
                                       * torch.clamp(sin_t, min=1e-6))
    return wo, pdf


def pdf_env_cdf(env: EnvCDF, wi):
    """The pdf of directions ``wi`` (pdf_li + draw_pdf_from_distribution,
    render_kernel.cu:258-269, 1342-1354); 0 where sin(theta) <= 0."""
    n_v, n_u = env.cdf.shape
    theta = torch.acos(torch.clamp(wi[..., 1], -1.0, 1.0))
    phi = torch.atan2(wi[..., 2], wi[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    sin_theta = torch.sin(theta)
    iu = torch.clamp((true_div(phi, 2.0 * math.pi) * n_u).to(torch.int64),
                     0, n_u - 1)
    iv = torch.clamp((true_div(theta, math.pi) * n_v).to(torch.int64), 0,
                     n_v - 1)
    mf = env.marginal_func[iv]
    cond = env.func[iv, iu] / torch.clamp(mf, min=1e-12)
    marg = mf / torch.clamp(env.marginal_int, min=1e-12)
    pdf = (marg * cond) / (2.0 * math.pi * math.pi
                           * torch.clamp(sin_theta, min=1e-6))
    return torch.where(sin_theta <= 0.0, 0.0, pdf)
