"""Each hand-written kernel against its plain PyTorch version on the card.

The ``cuda``-marked tests need an NVIDIA GPU and skip without one.  This
file imports no jax, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures jax).  The ABI checks at
the bottom run everywhere.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from torch_parity import agreement  # tests/, on sys.path under pytest
from vpt_tpu_torch.accel.shadow import attach_shadow_cache
from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.camera import Camera
from vpt_tpu_torch.lights.lights import PointLights
from vpt_tpu_torch.ops import probe
from vpt_tpu_torch.render import film as tfilm
from vpt_tpu_torch.render import fused, renderer, walk
from vpt_tpu_torch.render.integrator import _AtmParams, _EnvParams
from vpt_tpu_torch.render.params import RenderParams
from vpt_tpu_torch.scene.assets import ramp_lut
from vpt_tpu_torch.scene.scene import build_scene
from vpt_tpu_torch.volume.grid import HostGrid

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "vpt_tpu_torch", "csrc")


def _blob_scene(device, n=16, emission=False, color=False, **rows):
    """A 16^3 blob with one point light, shadow-baked; with an emission
    channel (and the ramp LUT) and a color channel where asked; ``rows``:
    build_scene's corner_dtype and octant_boxes."""
    z, y, x = np.mgrid[:n, :n, :n].astype(np.float32)
    r = np.sqrt((x - n / 2) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)
    dens = np.clip(1.0 - r / (n / 2.4), 0.0, 1.0).astype(np.float32)
    em = (0.7 * dens).astype(np.float32) if emission else None
    col = (np.stack([dens, 0.6 * dens, 0.25 + 0 * dens], -1).astype(
        np.float32) if color else None)
    g = HostGrid(density_zyx=dens, emission_zyx=em, color_zyx=col,
                 bbox_min=np.zeros(3, np.int32),
                 dim=np.array([n, n, n], np.int32),
                 transform=np.diag([0.2, 0.2, 0.2, 1.0]), voxel_size=0.2,
                 max_density=float(dens.max()), min_density=1e-6)
    s = build_scene([g], lights=PointLights.make([[2.0, 3.0, 4.0]],
                                                 [[1, 1, 1]], [30.0],
                                                 device=device),
                    emission_lut=ramp_lut(), device=device, **rows)
    lo, hi = s.root_pmin.cpu().numpy(), s.root_pmax.cpu().numpy()
    c, d = (lo + hi) / 2, float(np.linalg.norm(hi - lo)) * 1.2
    s = dataclasses.replace(s, camera=Camera.make(
        c + np.array([0.0, 0.15 * d, d]), c, vfov=40.0, device=device))
    return attach_shadow_cache(s, 150.0, 30.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cached", "tracked"])
def test_k1_k2_match_plain(cuda_device, mode):
    s = _blob_scene(cuda_device)
    p = RenderParams(width=48, height=40, shadow_mode=mode,
                     environment_type=2, ray_depth=8)
    key = rng.render_key(0, 1)
    o, d = renderer._primary_rays_cuda(s.camera, p, key)
    o2, d2 = renderer.primary_rays_plain(s.camera, p, key)
    assert float((o - o2).abs().max()) <= 1e-5
    assert float((d - d2).abs().max()) <= 1e-5
    out = fused._fused_direct_cuda(s, p, key, o, d)
    ref = fused.fused_direct_plain(s, p, key, o, d)
    torch.cuda.synchronize()
    share, rel = agreement([x.cpu().numpy() for x in out],
                           [x.cpu().numpy() for x in ref])
    assert share >= 0.99 and rel <= 0.005, (share, rel)


def _same_bits(a, b):
    return all(x.shape == y.shape and torch.equal(x.view(torch.int32),
                                                  y.view(torch.int32))
               for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cached", "tracked"])
def test_k1_rays_in_kernel_match_buffer_route(cuda_device, mode):
    """K1's in-kernel-ray route writes the bits of its buffer route fed
    with K2's rays, and agrees with the plain pipeline."""
    s = _blob_scene(cuda_device)
    p = RenderParams(width=48, height=40, shadow_mode=mode,
                     environment_type=2, ray_depth=8)
    key = rng.render_key(0, 3)
    o, d = renderer._primary_rays_cuda(s.camera, p, key)
    tkey = renderer.tile_key(key)
    buf = fused._fused_direct_cuda(s, p, tkey, o, d)
    gen = renderer._trace_primary_cuda(s, p, key)
    torch.cuda.synchronize()
    assert _same_bits(gen, buf)
    ref = fused.fused_direct_plain(s, p, tkey,
                                   *renderer.primary_rays_plain(s.camera, p,
                                                                key))
    share, rel = agreement([x.cpu().numpy() for x in gen],
                           [x.cpu().numpy() for x in ref])
    assert share >= 0.99 and rel <= 0.005, (share, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cached", "tracked"])
@pytest.mark.parametrize("n", [1, 31, 33, 4097, "grid_lanes-1"])
def test_k1_drains_any_ray_count(cuda_device, mode, n):
    """The persistent grid ends with every ray written whatever the ray
    count: each ray's outputs equal its outputs in a larger launch bit for
    bit (its draws depend on its index only) and the plain version's, on
    both routes."""
    s = _blob_scene(cuda_device)
    if n == "grid_lanes-1":
        info = fused.launch_info(False, 128)
        n = info["sms"] * info["blocks_per_sm"] * info["threads"] - 1
    p = RenderParams(width=n, height=1, shadow_mode=mode,
                     environment_type=2, ray_depth=8)
    key = rng.render_key(0, 5)
    o, d = renderer._primary_rays_cuda(s.camera, p, key)
    tkey = renderer.tile_key(key)
    out = fused._fused_direct_cuda(s, p, tkey, o, d)
    o2, d2 = (torch.cat([x, x[:64]]) for x in (o, d))
    wide = fused._fused_direct_cuda(s, p, tkey, o2, d2)
    gen = renderer._trace_primary_cuda(s, p, key)
    torch.cuda.synchronize()
    assert _same_bits(out, tuple(x[:n] for x in wide))
    assert _same_bits(gen, out)
    ref = fused.fused_direct_plain(s, p, tkey, o, d)
    share, rel = agreement([x.cpu().numpy() for x in out],
                           [x.cpu().numpy() for x in ref])
    assert share >= 0.99 and rel <= 0.005, (share, rel)


def _k3_inputs(dev, hw, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g).to(dev)
    film = tfilm.Film(rand(*hw, 3), rand(*hw), rand(*hw), rand(*hw),
                      rand(*hw))
    val = rand(*hw, 3) * 4.0
    val.view(-1, 3)[::5, 1] = float("nan")
    val.view(-1, 3)[1::7, 2] = float("inf")
    val.view(-1, 3)[2::9, 0] = -float("inf")
    alpha = rand(*hw)
    alpha.view(-1)[::3] = float("inf")
    alpha.view(-1)[1::4] = float("nan")
    return film, val, alpha, [rand(*hw) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(24, 20), (7, 9), (1, 3), (1079, 1921)])
@pytest.mark.parametrize("absent", [(), ("depth",), ("cost", "trunc"),
                                    ("depth", "cost", "trunc")])
def test_k3_matches_plain(cuda_device, hw, absent):
    """K3 equals accumulate_plain bit for bit, H*W a multiple of 4 and not
    (the scalar tail), with NaN and +-Inf planted in radiance and alpha,
    and with depth, cost or trunc absent (carried over)."""
    film, val, alpha, aux = _k3_inputs(cuda_device, hw)
    kw = dict(zip(("depth", "cost", "trunc"), aux))
    for name in absent:
        kw[name] = None
    before = tfilm.FILM_ACCUMULATE.launches
    f1 = tfilm.accumulate(film, val, alpha, 4, **kw)
    f2 = tfilm.accumulate_plain(film, val, alpha, 4, **kw)
    assert tfilm.FILM_ACCUMULATE.launches == before + 1
    for name in ("accum", "alpha", "depth", "cost", "trunc"):
        assert torch.equal(getattr(f1, name).view(torch.int32),
                           getattr(f2, name).view(torch.int32)), name
    for name in absent:
        assert getattr(f1, name) is getattr(film, name)


def _offset_view(t, offset):
    """A contiguous copy of ``t`` that starts ``offset`` floats into a
    fresh buffer (not 16-byte aligned for offsets 1-3)."""
    flat = torch.empty(t.numel() + offset, device=t.device)
    out = flat[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["value", "film.alpha", "trunc"])
def test_k3_refuses_misaligned_views(cuda_device, which):
    """K3 takes any contiguous view (test_k3_takes_offset_views); a view
    that is not contiguous is refused, not copied or taken by another
    path."""
    film, val, alpha, aux = _k3_inputs(cuda_device, (8, 8))
    if which == "value":
        val = val.transpose(0, 1)
    elif which == "film.alpha":
        film = dataclasses.replace(film, alpha=film.alpha.t())
    else:
        aux[2] = aux[2].t()
    with pytest.raises(ValueError, match="contiguous"):
        tfilm.accumulate(film, val, alpha, 1, *aux)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("which", ["value", "film.accum", "alpha", "all"])
@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_k3_takes_offset_views(cuda_device, offset, which, hw):
    """Views starting 1-3 floats past a 16-byte boundary take K3's scalar
    route, bit for bit accumulate_plain."""
    film, val, alpha, aux = _k3_inputs(cuda_device, hw)
    if which in ("value", "all"):
        val = _offset_view(val, offset)
    if which in ("film.accum", "all"):
        film = dataclasses.replace(film, accum=_offset_view(film.accum,
                                                            offset))
    if which in ("alpha", "all"):
        alpha = _offset_view(alpha, offset)
        aux = [_offset_view(t, offset) for t in aux]
    before = tfilm.FILM_ACCUMULATE.launches
    got = tfilm.accumulate(film, val, alpha, 4, *aux)
    want = tfilm.accumulate_plain(film, val, alpha, 4, *aux)
    torch.cuda.synchronize()
    assert tfilm.FILM_ACCUMULATE.launches == before + 1
    for name in ("accum", "alpha", "depth", "cost", "trunc"):
        assert torch.equal(getattr(got, name).view(torch.int32),
                           getattr(want, name).view(torch.int32)), name


def _c3_map():
    ty = np.linspace(1.0, 0.0, 32, dtype=np.float32)[:, None, None]
    env = (np.array([0.3, 0.5, 1.0], np.float32) * ty
           + np.array([0.9, 0.6, 0.3], np.float32) * (1.0 - ty))
    env = np.broadcast_to(env, (32, 64, 3)).copy()
    env[8, 21] = [40.0, 38.0, 30.0]
    return env


def _env_scene(device, env):
    from vpt_tpu_torch.scene.scene import attach_env_map
    s = _blob_scene(device)
    return attach_env_map(s, _c3_map()) if env == "hdri" else s


ENV_TYPES = {"sky": 0, "hdri": 1}
K4_RTOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("env", list(ENV_TYPES))
def test_k4_matches_plain(cuda_device, env):
    """K4 adds environment_radiance(dir) * beta to L, held against the
    plain version on the card (the same libdevice functions: rtol 1e-5)
    and on the CPU (the host's exp, pow, atan2 and acos)."""
    from vpt_tpu_torch.render import integrator
    s = _env_scene(cuda_device, env)
    p = RenderParams(environment_type=ENV_TYPES[env], sky_mult=0.7,
                     sky_color=(1.0, 0.9, 0.8))
    g = torch.Generator().manual_seed(7)
    n = 5003
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    beta = torch.rand((n, 3), generator=g)
    beta[::11] = 0.0
    L = torch.rand((n, 3), generator=g)
    before = integrator.ENVIRONMENT.launches
    got = integrator.add_environment(s, p, L.to(cuda_device),
                                     beta.to(cuda_device), d.to(cuda_device))
    want = L.to(cuda_device) + integrator.environment_radiance(
        s, p, d.to(cuda_device), d.to(cuda_device)) * beta.to(cuda_device)
    torch.cuda.synchronize()
    assert integrator.ENVIRONMENT.launches == before + 1
    assert torch.isfinite(got).all()
    assert torch.allclose(got, want, rtol=K4_RTOL, atol=0.0)
    cpu = dataclasses.replace(s, env_map=None if s.env_map is None
                              else s.env_map.cpu())
    host = L + integrator.environment_radiance(cpu, p, d, d) * beta
    assert torch.allclose(got.cpu(), host, rtol=2e-3, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("env", list(ENV_TYPES))
@pytest.mark.parametrize("n", [1, 255, 5003])
def test_k4_kernels_equal_plain_bit_for_bit(cuda_device, env, n):
    """K4's sky and HDRI kernels (one template instance each) against
    environment_radiance on the card, bit for bit (the sky divides by HR
    and HM with div_known2, which is IEEE division), on directions that
    include the horizon, the poles and the sun."""
    from vpt_tpu_torch.core.vecmath import degree_to_cartesian
    from vpt_tpu_torch.render import integrator
    s = _env_scene(cuda_device, env)
    p = RenderParams(environment_type=ENV_TYPES[env], sky_mult=0.7,
                     sky_color=(1.0, 0.9, 0.8))
    g = torch.Generator().manual_seed(n)
    d = torch.randn((n, 3), generator=g)
    d[:, 1] = d[:, 1] * 0.05 if n > 1 else d[:, 1]
    fixed = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
                          [1.0, 0.0, 0.0]])
    d[:min(n, 3)] = fixed[:min(n, 3)]
    if n > 3:
        d[3] = degree_to_cartesian(p.azimuth, p.elevation, "cpu")
    d = (d / d.norm(dim=1, keepdim=True)).to(cuda_device)
    beta = torch.rand((n, 3), generator=g).to(cuda_device)
    L = torch.rand((n, 3), generator=g).to(cuda_device)
    got = integrator.add_environment(s, p, L.clone(), beta, d)
    want = L + integrator.environment_radiance(s, p, d, d) * beta
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hr", "hm"])
@pytest.mark.parametrize("lo", [0x3F800000, 0x0D800000 - 2 ** 19, 0x0,
                                0x80000000, 0x7F800000 - 2 ** 19,
                                0xFF800000 - 2 ** 19])
def test_div_known_sweep_on_the_card(cuda_device, name, lo):
    """The sweep kernel finds no mismatch between div_known2 and IEEE
    division in 2^20 patterns at each edge of div_known2's paths, and with
    a reciprocal 0.1% off it counts what the CPU emulation counts."""
    from vpt_tpu_torch.render import integrator
    from vpt_tpu_torch.sky.procedural import sky_constants
    c = sky_constants()
    d, y = c[name], c[name + "_inv"]
    hi = lo + 2 ** 20
    assert integrator.div_known_sweep(d, y, lo, hi, cuda_device) == (0, None)
    off = float(np.float32(y * 1.001))
    got = integrator.div_known_sweep(d, off, lo, hi, cuda_device)
    assert got == integrator.div_known_sweep(d, off, lo, hi, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("setting", ["aperture_0", "aperture_0.5",
                                     "origin_minus_0"])
@pytest.mark.parametrize("wh", [(48, 40), (37, 7), (256, 3)])
def test_k2_lens_settings_equal_plain_bit_for_bit(cuda_device, setting, wh):
    """K2 against primary_rays_plain bit for bit where it skips the lens
    draws (aperture 0) and where it takes them (aperture 0.5, and a -0.0
    origin component, whose sum with a +0.0 offset is +0.0), at frame
    sizes whose pixel count is and is not a multiple of K2's block."""
    s = _blob_scene(cuda_device)
    cam = s.camera
    if setting == "aperture_0.5":
        cam = dataclasses.replace(cam, lens_radius=torch.tensor(
            0.25, device=cuda_device))
    elif setting == "origin_minus_0":
        o = cam.origin.clone()
        o[0] = -0.0
        cam = dataclasses.replace(cam, origin=o)
    assert renderer.lens_draws_needed(cam) == (setting != "aperture_0")
    p = RenderParams(width=wh[0], height=wh[1])
    key = rng.render_key(0, 3)
    got = renderer._primary_rays_cuda(cam, p, key)
    want = renderer.primary_rays_plain(cam, p, key)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cached", "tracked"])
def test_k1_routes_agree_with_the_lens_drawn(cuda_device, mode):
    """K1's in-kernel-ray route (each lane makes its ray with K2's code,
    taking the lens draws at aperture 0.5) against K2 and K1's buffer
    route, bit for bit."""
    s = _blob_scene(cuda_device)
    s = dataclasses.replace(s, camera=dataclasses.replace(
        s.camera, lens_radius=torch.tensor(0.25, device=cuda_device)))
    p = RenderParams(width=48, height=40, shadow_mode=mode,
                     environment_type=2, ray_depth=8)
    key = rng.render_key(0, 4)
    a = renderer._trace_primary_cuda(s, p, key)
    b = renderer._trace_buffers_cuda(s, p, key)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("env", list(ENV_TYPES))
@pytest.mark.parametrize("mode", ["cached", "tracked"])
def test_k1_k4_env_match_plain(cuda_device, env, mode):
    """A sample with the simple sky or HDRI through the renderer on the
    card (K1, then K4) against the plain pipeline, and K4 launched once a
    sample."""
    from vpt_tpu_torch.render import integrator
    s = _env_scene(cuda_device, env)
    p = RenderParams(width=48, height=40, shadow_mode=mode,
                     environment_type=ENV_TYPES[env], ray_depth=8)
    key = rng.render_key(0, 2)
    before = integrator.ENVIRONMENT.launches
    val, alpha, aux = renderer.render_rays(s, p, key)
    torch.cuda.synchronize()
    assert integrator.ENVIRONMENT.launches == before + 1
    ref = fused.fused_direct_plain(
        s, p, renderer.tile_key(key),
        *renderer.primary_rays_plain(s.camera, p, key))
    got = (val.reshape(-1, 3), alpha.reshape(-1), aux["cost"].reshape(-1),
           aux["trunc"].reshape(-1))
    share, rel = agreement([x.cpu().numpy() for x in got],
                           [x.cpu().numpy() for x in ref])
    assert share >= 0.99 and rel <= 0.005, (share, rel)
    assert float(ref[0].mean()) > 0.0


# K1's EXT variant: (emission, color, volume_depth, environment type)
EXT_CASES = {"emission": (True, False, 1, 2), "color": (False, True, 1, 2),
             "both_vd2": (True, True, 2, 2), "vd3": (False, False, 3, 2),
             "color_hdri": (False, True, 1, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EXT_CASES))
@pytest.mark.parametrize("mode", ["cached", "tracked"])
def test_k1_ext_variant_matches_plain(cuda_device, mode, case):
    """K1's EXT variant (the EMIT walk with the emission LUT, Cd,
    volume_depth > 1) on both routes against the plain loop by the share
    rule, the in-kernel-ray route bit for bit the buffer route; EXT counted
    once a launch, and never for a density-only scene at depth 1."""
    from vpt_tpu_torch.scene.scene import attach_env_map
    em, col, vd, env = EXT_CASES[case]
    s = _blob_scene(cuda_device, emission=em, color=col)
    if env == 1:
        s = attach_env_map(s, _c3_map())
    p = RenderParams(width=48, height=40, shadow_mode=mode,
                     environment_type=env, ray_depth=8, volume_depth=vd,
                     emission_scale=1.5)
    key = rng.render_key(0, 5)
    o, d = renderer._primary_rays_cuda(s.camera, p, key)
    tkey = renderer.tile_key(key)
    before = fused.FUSED_DIRECT_EXT.launches
    buf = fused._fused_direct_cuda(s, p, tkey, o, d)
    gen = renderer._trace_primary_cuda(s, p, key)
    torch.cuda.synchronize()
    assert fused.FUSED_DIRECT_EXT.launches == before + 2
    assert _same_bits(gen, buf)
    ref = fused.fused_direct_plain(s, p, tkey, o, d)
    share, rel = agreement([x.cpu().numpy() for x in buf],
                           [x.cpu().numpy() for x in ref])
    assert share >= 0.99 and rel <= 0.005, (share, rel)
    assert float(ref[0].mean()) > 0.0
    if em:
        dark = p.replace(sun_mult=0.0)
        lit = fused._fused_direct_cuda(s, dark, tkey, o, d)[0]
        assert float(lit.mean()) > 0.0    # emission alone lights it
    plain = _blob_scene(cuda_device)
    before = fused.FUSED_DIRECT_EXT.launches
    fused._fused_direct_cuda(plain, p.replace(volume_depth=1), tkey, o, d)
    assert fused.FUSED_DIRECT_EXT.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cached", "tracked"])
def test_k1_queued_budget_matches_plain(cuda_device, mode):
    """K1 at Q = 16: a cut ray is the reference's unretired slot and a
    finished ray the bits of a Q = 1 launch with a 16 times larger
    budget, on both routes; the same as the plain version's rule."""
    s = _env_scene(cuda_device, "sky")
    kw = dict(width=48, height=40, shadow_mode=mode, environment_type=0,
              ray_depth=8, density_mult=16.0)
    p16, p1 = RenderParams(max_fused_steps=1, **kw), \
        RenderParams(max_fused_steps=16, **kw)
    key = rng.render_key(0, 4)
    tkey = renderer.tile_key(key)
    o, d = renderer._primary_rays_cuda(s.camera, p16, key)
    q = fused._fused_direct_cuda(s, p16, tkey, o, d, queue=16)
    one = fused._fused_direct_cuda(s, p1, tkey, o, d)
    gen = fused._fused_direct_primary_cuda(
        s, p16, tkey, renderer._raygen_for_sample(
            renderer.prepare_raygen(s.camera, p16), key), queue=16)
    ref = fused.fused_direct_plain(s, p16, tkey, o, d, queue=16)
    torch.cuda.synchronize()
    assert _same_bits(gen, q)
    cut = q[3] == 1.0
    assert 0 < int(cut.sum()) < cut.numel()
    for a, b in zip(q, one):
        assert torch.equal(a[~cut], b[~cut])
    for x in (q[0], q[1], q[2], q[4]):
        assert not bool(x[cut].any())
    share, rel = agreement([x.cpu().numpy() for x in q],
                           [x.cpu().numpy() for x in ref])
    assert share >= 0.99 and rel <= 0.005, (share, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cached", "tracked"])
@pytest.mark.parametrize("wh", [(29, 37), (7, 6), (5, 1)])
def test_renderer_feeds_k3_at_ragged_sizes(cuda_device, mode, wh):
    """ProgressiveRenderer at a pixel count that is no multiple of 4 (odd,
    and 2 mod 4): K1's output views reach K3 16-byte aligned, and each
    step's film is accumulate_plain's on the same sample, bit for bit."""
    s = _blob_scene(cuda_device)
    p = RenderParams(width=wh[0], height=wh[1], shadow_mode=mode,
                     environment_type=2, ray_depth=4)
    r = renderer.ProgressiveRenderer(s, p)
    for it in range(2):
        prev = r.film
        val, alpha, aux = renderer.render_rays(
            s, p, rng.render_key(p.seed, it), r.launches)
        want = tfilm.accumulate_plain(prev, val, alpha, it, aux["depth"],
                                      aux["cost"], aux["trunc"])
        got = r.step()
        for name in ("accum", "alpha", "depth", "cost", "trunc"):
            assert torch.equal(getattr(got, name).view(torch.int32),
                               getattr(want, name).view(torch.int32)), name
    assert float(r.film.cost.sum()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode,want", [("cached", [2, 2, 0, 0]),
                                       ("tracked", [0, 2, 2, 2])])
def test_wrappers_launch_kernels(cuda_device, mode, want):
    """The renderer runs K3 and K1 on its shadow mode's ray source: the
    in-kernel-ray route for cached shadows, K2 and K1's buffer route for
    tracked ones."""
    s = _blob_scene(cuda_device)
    kernels = (fused.FUSED_DIRECT_PRIMARY, tfilm.FILM_ACCUMULATE,
               fused.FUSED_DIRECT, renderer.RAYGEN)
    for k in kernels:
        k.launches = 0
    p = RenderParams(width=16, height=16, shadow_mode=mode,
                     environment_type=2, ray_depth=4)
    r = renderer.ProgressiveRenderer(s, p)
    r.render(2)
    assert [k.launches for k in kernels] == want
    assert torch.isfinite(r.film.accum).all()


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_reassigned_scene_and_params_are_rendered(device):
    """A live renderer renders the scene and params last assigned to it
    (frame size, shadow mode, density and camera), held against the
    plain versions on the same inputs."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    s = _blob_scene(torch.device(device))
    p1 = RenderParams(width=16, height=16, shadow_mode="cached",
                      environment_type=2, ray_depth=4)
    r = renderer.ProgressiveRenderer(s, p1)
    r.step(1)
    lo, hi = s.root_pmin.cpu().numpy(), s.root_pmax.cpu().numpy()
    s2 = dataclasses.replace(s, camera=Camera.make(
        hi + (hi - lo), (lo + hi) / 2, vfov=35.0, aspect=24 / 20,
        device=device))
    p2 = p1.replace(width=24, height=20, shadow_mode="tracked",
                    density_mult=2.0, ray_depth=6)
    r.scene, r.params = s2, p2
    r.reset()
    film = r.step(1)
    key = rng.render_key(p2.seed, 0)
    o, d = renderer.primary_rays_plain(s2.camera, p2, key)
    tkey = renderer.tile_key(key)
    ref = fused.fused_direct_plain(s2, p2, tkey, o, d)
    got = (film.accum.reshape(-1, 3), film.alpha.reshape(-1),
           film.cost.reshape(-1), film.trunc.reshape(-1))
    share, rel = agreement([x.cpu().numpy() for x in got],
                           [x.cpu().numpy() for x in ref])
    assert share >= 0.99 and rel <= 0.005, (share, rel)
    assert float(ref[0].mean()) > 0.0


@pytest.mark.cuda
def test_cli_renders_on_the_card(cuda_device, tmp_path, monkeypatch):
    """`vpt-torch render` without --cpu renders on the card through K1
    (its in-kernel-ray route, K2's code inside) and K3, and writes a
    non-black PNG and a finite EXR."""
    from vpt_tpu_torch.app import cli
    from vpt_tpu_torch.utils.exr import read_exr_rgb
    from vpt_tpu_torch.utils.io import read_png
    from vpt_tpu_torch.volume import procedural

    monkeypatch.setattr(procedural, "default_procedural_grid",
                        lambda device: procedural.create_procedural_grid(
                            vmin=(-32.0,) * 3, vmax=(32.0,) * 3,
                            scale=0.03, device=device))
    kernels = (fused.FUSED_DIRECT_PRIMARY, tfilm.FILM_ACCUMULATE,
               fused.FUSED_DIRECT, renderer.RAYGEN)
    before = [k.launches for k in kernels]
    out = tmp_path / "card.png"
    cli.main(["render", "procedural", "-o", str(out), "--spp", "4",
              "--width", "64", "--height", "64", "--env-type", "black",
              "--shadow-mode", "cached", "--save-exr",
              "--light", "0", "48", "48", "1", "1", "1", "2000"])
    assert [k.launches - b for k, b in zip(kernels, before)] == [4, 4, 0, 0]
    img = read_png(str(out))
    assert img.shape == (64, 64, 3) and img.max() > 0
    rad = read_exr_rgb(str(tmp_path / "card.exr"))
    assert np.isfinite(rad).all() and rad.mean() > 0


def _same(a, b):
    """Equal values, NaN where the other has NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.cuda
def test_probe_kernels_match_plain(cuda_device):
    """P1-P3 equal their plain versions exactly on the card."""
    g = torch.Generator().manual_seed(0)
    table = torch.rand((5000, 31), generator=g).to(cuda_device)
    idx = torch.randint(0, 5000, (7001,), generator=g,
                        dtype=torch.int32).to(cuda_device)
    for t in (table, table[:, 0]):
        assert torch.equal(probe.gather_rows(t, idx),
                           probe.gather_rows_plain(t, idx))
    x = torch.rand((300, 128), generator=g).to(cuda_device)
    for axis, iters, dtype in ((0, 1, torch.uint32), (0, 64, torch.int32),
                               (1, 64, torch.int32)):
        i = torch.randint(0, x.shape[axis], x.shape, generator=g).to(
            dtype).to(cuda_device)
        assert torch.equal(probe.take_along(x, i, axis, iters),
                           probe.take_along_plain(x, i, axis, iters))
    for axis, shift in ((1, 3), (0, -7)):
        assert torch.equal(probe.roll(x, shift, axis),
                           probe.roll_plain(x, shift, axis))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 10, 31, 128])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "column_of_wider",
                                    "misaligned"])
def test_gather_rows_matches_plain(cuda_device, width, clip, layout):
    """P1 equals gather_rows_plain exactly (NaN where NaN), both modes,
    out-of-range indices planted (-1, -V, -V - 1, V, 100 V, 2^31 - 1,
    -2^31), a batch that is no multiple of a block's rows, on a
    contiguous table, on columns read in place from a wider one, and on a
    table 4 bytes off a 16-byte boundary (scalar loads)."""
    r = np.random.default_rng(width)
    v, b = 5000, 7001
    wide = torch.from_numpy(r.uniform(-1, 2, (v, width + 3)).astype(
        np.float32)).to(cuda_device)
    if layout == "contiguous":
        table = wide[:, :width].contiguous()
    elif layout == "column_of_wider":
        table = wide[:, 1:1 + width] if width > 1 else wide[:, 1]
    else:
        flat = torch.empty(v * width + 1, device=cuda_device)
        table = flat[1:].view(v, width)
        table.copy_(wide[:, :width])
    idx = r.integers(0, v, b)
    edges = [-1, -v, -v - 1, v, 100 * v, 2 ** 31 - 1, -2 ** 31]
    idx[r.choice(b, 70, replace=False)] = np.resize(edges, 70)
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda_device)
    before = probe.GATHER_ROWS.launches
    got = probe.gather_rows(table, idx, clip)
    assert probe.GATHER_ROWS.launches == before + 1
    want = probe.gather_rows_plain(table, idx, clip)
    assert got.shape == want.shape and _same(got, want)
    assert bool(torch.isnan(got).any()) != clip


# (N, C, axis, the design take_along_design picks at iters > 1 and at
# iters 1): each design on both axes where it applies, strips of 8 and
# of 4 columns, C % 4 != 0, a last strip of 4 columns of 8, and shapes
# whose strip does not fit (the L2 route)
P2_SHAPES = [(512, 128, 0, "smem_cols", "global"),
             (832, 128, 1, "smem_rows", "global"),
             (4096, 128, 0, "smem_cols", "global"),
             (4096, 128, 1, "smem_rows", "global"),
             (8000, 68, 0, "smem_cols", "global"),
             (301, 30, 0, "smem_cols", "global"),
             (512, 132, 0, "smem_cols", "global"),
             (67, 130, 1, "smem_rows", "global"),
             (20000, 8, 0, "global", "global"),
             (3, 60001, 1, "global", "global"),
             (20001, 7, 0, "global", "global")]


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 5, 64])
@pytest.mark.parametrize("shape", P2_SHAPES, ids=lambda s: "x".join(
    map(str, s[:3])))
def test_take_along_designs_match_plain(cuda_device, shape, iters):
    """P2 equals take_along_plain exactly in every design on both axes,
    with int32 indices in [-len, 0) (counted from the end) and outside
    [-len, len) (NaN)."""
    n, c, axis, design, design1 = shape
    length = (n, c)[axis]
    r = np.random.default_rng(iters)
    x = torch.from_numpy(r.uniform(-1, 2, (n, c)).astype(np.float32))
    i = r.integers(0, length, (n, c)).astype(np.int32)
    bad = r.random((n, c)) < 0.01
    i[bad] = r.choice([-1, -length, -length - 1, length, 2 ** 31 - 1,
                       -2 ** 31], int(bad.sum()))
    x, i = x.to(cuda_device), torch.from_numpy(i).to(cuda_device)
    want = probe.take_along_design(n, c, axis, iters, torch.int32,
                                   *probe.device_limits(cuda_device)).name
    assert want == (design if iters > 1 else design1)
    before = dict(probe.design_launches)
    got = probe.take_along(x, i, axis, iters)
    assert probe.design_launches[want] == before[want] + 1
    exp = probe.take_along_plain(x, i, axis, iters)
    assert torch.isnan(got).any() and _same(got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_uint32_high_indices(cuda_device, axis):
    """uint32 indices are read as int32 (iters 1): 2^32 - 1 is -1 and
    reads the last row or column; 2^31 + 5 and len read NaN."""
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.uniform(size=(256, 132)).astype(np.float32))
    length = x.shape[axis]
    i = r.integers(0, length, x.shape).astype(np.uint32)
    i[::7, ::3] = np.uint32(2 ** 31 + 5)
    i[::11, 1::5] = np.uint32(2 ** 32 - 1)
    i[::13, 2::5] = np.uint32(length)
    x = x.to(cuda_device)
    iu = torch.from_numpy(i).to(cuda_device)
    got = probe.take_along(x, iu, axis)
    assert _same(got, probe.take_along_plain(x, iu, axis))
    bad = (i >= length) & (i < 2 ** 32 - length)
    assert int(torch.isnan(got).sum()) == int(bad.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128), (4096, 128), (37, 131),
                                   (5, 3)])
@pytest.mark.parametrize("shift", [3, -5, 4, 0, 1000])
@pytest.mark.parametrize("axis", [0, 1])
def test_roll_matches_plain(cuda_device, shape, shift, axis):
    """P3 equals torch.roll exactly, shifts either way on both axes,
    C % 4 == 0 (16-byte rows) and not."""
    x = torch.arange(shape[0] * shape[1], dtype=torch.float32,
                     device=cuda_device).reshape(shape)
    assert torch.equal(probe.roll(x, shift, axis),
                       probe.roll_plain(x, shift, axis))


def _c5_scene(device, resolution=16):
    """The c5 golden's 27 instances of the 12^3 blob (K = 3 at R 16),
    built by the port on ``device``, framed as the golden frames it."""
    from vpt_tpu_torch.tools import common
    ids, xforms = common.golden_c5_instances()
    return common.golden_camera(build_scene(
        [common.golden_blob()], instance_grid_ids=ids, instance_xforms=xforms,
        majorant_resolution=resolution, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["buffers", "in_kernel"])
@pytest.mark.parametrize("mode", ["cached", "tracked"])
def test_k1_cells_variant_matches_plain(cuda_device, mode, route):
    """K1's CELLS variant on an instanced scene with K = 3 agrees with
    fused_direct_plain (the share rule), on both routes, and launches
    the CELLS variant once."""
    s = _c5_scene(cuda_device)
    assert s.majorant.cell_instances.shape[1] == 3
    if mode == "cached":
        s = attach_shadow_cache(s, 150.0, 30.0, world_resolution=32)
    p = RenderParams(width=64, height=48, shadow_mode=mode,
                     environment_type=3, ray_depth=4, max_fused_steps=256)
    key = rng.render_key(0, 5)
    tkey = renderer.tile_key(key)
    o, d = renderer._primary_rays_cuda(s.camera, p, key)
    before = fused.FUSED_DIRECT_CELLS.launches
    out = (fused._fused_direct_cuda(s, p, tkey, o, d) if route == "buffers"
           else renderer._trace_primary_cuda(s, p, key))
    assert fused.FUSED_DIRECT_CELLS.launches == before + 1
    ref = fused.fused_direct_plain(s, p, tkey, o, d)
    torch.cuda.synchronize()
    share, rel = agreement([x.cpu().numpy() for x in out],
                           [x.cpu().numpy() for x in ref])
    assert share >= 0.99 and rel <= 0.005, (share, rel)
    assert float(ref[2].mean()) > 1.0 and float(ref[0].mean()) > 0.0


def _loop_scene(device, ext, n_inst=4):
    """n_inst instances of two grids, a 24^3 puff (with emission and color
    where ``ext``) and a 20^3 one without, alternating, 2.0 apart with
    overlapping boxes: below the list threshold at 4, with lists at 12;
    one point light; framed as the c5 golden, closer."""
    from vpt_tpu_torch.tools import common
    xforms = []
    for i in range(n_inst):
        xf = np.diag([0.1, 0.1, 0.1, 1.0])
        xf[3, :3] = (2.0 * (i % 4), 0.3 * (i % 3), 2.0 * (i // 4))
        xforms.append(xf)
    s = build_scene(
        [common.bench_blob(n=24, emission=ext, color=ext),
         common.bench_blob(n=20)],
        instance_grid_ids=[i % 2 for i in range(n_inst)],
        instance_xforms=xforms, majorant_resolution=16,
        lights=PointLights.make([[2.0, 4.0, 3.0]], [[1, 1, 1]], [30.0],
                                device=device),
        emission_lut=ramp_lut(), device=device)
    return common.golden_camera(s, dist_scale=0.7)


INSTANCED_CASES = {"loop": (4, False), "loop_ext": (4, True),
                   "cells_ext": (12, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("vdepth", [1, 2])
@pytest.mark.parametrize("route", ["buffers", "in_kernel"])
@pytest.mark.parametrize("mode", ["cached", "tracked"])
@pytest.mark.parametrize("case", list(INSTANCED_CASES))
def test_k1_loop_and_cells_ext_match_plain(cuda_device, case, mode, route,
                                           vdepth):
    """K1's CELLS instances in loop mode (4 instances of two grids, the
    world tau grid in cached mode) and with EXT (emission, color and
    volume_depth 2 on the loop and on cell lists) agree with
    fused_direct_plain by the share rule, on both routes, and count
    their launches."""
    n_inst, ext = INSTANCED_CASES[case]
    s = _loop_scene(cuda_device, ext, n_inst)
    loop = s.majorant.cell_instances is None
    assert loop == (n_inst <= 8)
    if mode == "cached":
        s = attach_shadow_cache(s, 150.0, 30.0, world_resolution=24)
        assert (s.world_tau is not None) == loop
    p = RenderParams(width=64, height=48, shadow_mode=mode,
                     environment_type=3, ray_depth=4, max_fused_steps=256,
                     emission_scale=2.0, volume_depth=vdepth)
    key = rng.render_key(0, 5)
    tkey = renderer.tile_key(key)
    o, d = renderer._primary_rays_cuda(s.camera, p, key)
    counters = (fused.FUSED_DIRECT_LOOP, fused.FUSED_DIRECT_CELLS,
                fused.FUSED_DIRECT_CELLS_EXT, fused.FUSED_DIRECT_EXT)
    before = [k.launches for k in counters]
    out = (fused._fused_direct_cuda(s, p, tkey, o, d) if route == "buffers"
           else renderer._trace_primary_cuda(s, p, key))
    extended = ext or vdepth > 1
    assert [k.launches - b for k, b in zip(counters, before)] == [
        int(loop), int(not loop), int(extended), int(extended)]
    ref = fused.fused_direct_plain(s, p, tkey, o, d)
    torch.cuda.synchronize()
    share, rel = agreement([x.cpu().numpy() for x in out],
                           [x.cpu().numpy() for x in ref])
    assert share >= 0.99 and rel <= 0.005, (share, rel)
    assert float(ref[2].mean()) > 1.0 and float(ref[0].mean()) > 0.0


@pytest.mark.cuda
def test_k1_cells_loop_ext_launch_info(cuda_device):
    """The CELLS instances with LOOP, with EXT and with both exist on both
    routes and every DEFER, and the density-only CELLS instances keep 5
    blocks an SM."""
    for rik in (False, True):
        for defer in (0, 1, 2):
            for ext, loop in ((True, False), (False, True), (True, True)):
                info = fused.launch_info(rik, 128, defer, ext, True,
                                         loop=loop)
                assert info["blocks_per_sm"] >= 1 and info["registers"] > 0
            assert fused.launch_info(rik, 128, defer, False,
                                     True)["blocks_per_sm"] == 5


@pytest.mark.cuda
def test_union_resample_on_the_card_matches_cpu(cuda_device):
    """resample_union_grid on the card equals the CPU's within float
    rounding (the float64 coordinates' products may round apart)."""
    from vpt_tpu_torch.tools import common
    from vpt_tpu_torch.volume.union import resample_union_grid
    ids, xforms = common.cloud_xforms(64)
    grids = [common.bench_blob(n=24, emission=True, color=True)]
    got = resample_union_grid(grids, ids, xforms, 96, device=cuda_device)
    want = resample_union_grid(grids, ids, xforms, 96, device="cpu")
    for f in ("density_zyx", "emission_zyx", "color_zyx"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("resolution", [16, 64])
def test_instanced_build_on_the_card_equals_cpu(cuda_device, resolution):
    """build_scene with N instances on the card (box and octant growth in
    torch there) gives the tables of the same call on the CPU exactly, and
    so does the shadow bake within float rounding."""
    import dataclasses as dc
    got, want = _c5_scene(cuda_device, resolution), _c5_scene("cpu",
                                                              resolution)
    for f in dc.fields(want.majorant):
        assert torch.equal(getattr(got.majorant, f.name).cpu(),
                           getattr(want.majorant, f.name)), f.name
    assert torch.equal(got.instances.packed_rows.cpu(),
                       want.instances.packed_rows)
    assert torch.equal(got.atlas.density_corners.cpu(),
                       want.atlas.density_corners)
    tg = attach_shadow_cache(got, 150.0, 30.0, world_resolution=32)
    tw = attach_shadow_cache(want, 150.0, 30.0, world_resolution=32)
    np.testing.assert_allclose(tg.majorant.cell_rows.cpu().numpy(),
                               tw.majorant.cell_rows.numpy(), rtol=1e-5,
                               atol=1e-5)


def _c_fields(source, struct):
    """Field names of a C struct in declaration order (arrays by name),
    from the source or the headers it includes."""
    text = open(os.path.join(CSRC, source)).read()
    for h in re.findall(r'#include "([^"]+)"', text):
        text += open(os.path.join(CSRC, h)).read()
    body = re.search(r"struct %s \{(.*?)\};" % struct, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        decl = re.sub(r"^(const\s+)?\w+\s+", "", decl)
        names += [re.sub(r"\[\d+\]|\*", "", n).strip()
                  for n in decl.split(",")]
    return names


@pytest.mark.parametrize("source,struct,mirror", [
    ("fused_direct.cu", "FusedParams", fused._FusedParams),
    ("fused_direct.cu", "ExtParams", fused._ExtParams),
    ("fused_direct.cu", "CellParams", fused._CellParams),
    ("raygen.cuh", "RaygenParams", renderer._RaygenParams),
    ("probe_launch.cuh", "ProbeLaunch", probe._ProbeLaunch),
    ("gather_rows.cu", "GatherLaunch", probe._GatherLaunch),
    ("film_accumulate.cu", "FilmArgs", tfilm._FilmArgs),
    ("environment.cu", "EnvParams", _EnvParams),
    ("environment.cu", "AtmParams", _AtmParams),
    ("walk.cu", "WalkParams", walk._WalkParams),
    ("walk.cu", "WalkEnv", _EnvParams),
    ("walk.cu", "WalkTables", walk._WalkTables),
    ("walk.cu", "WalkScene", walk._WalkScene),
    ("walk.cu", "WalkWork", walk._WalkWork)])
def test_ctypes_mirrors_match_c_structs(source, struct, mirror):
    """The ctypes launch structs list the C structs' fields in order."""
    assert _c_fields(source, struct) == [f[0] for f in mirror._fields_]


GOLDEN_LUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "golden", "tiny_luts.npz")
TINY_DIMS = dict(transmittance_w=64, transmittance_h=16, r=4, mu=32, mu_s=8,
                 nu=4, irradiance_w=16, irradiance_h=4)


def _atmosphere_scene(device, sphere=False, **rows):
    """The 16^3 blob scene with the golden tiny LUTs attached, and a
    sphere below its centre where asked; ``rows`` as _blob_scene's."""
    from vpt_tpu_torch.scene.geometry import Sphere
    from vpt_tpu_torch.scene.scene import attach_atmosphere
    from vpt_tpu_torch.sky.bruneton import LutDims
    s = _blob_scene(device, **rows)
    if sphere:
        c = ((s.root_pmin + s.root_pmax) / 2).cpu().numpy()
        s = dataclasses.replace(s, sphere=Sphere.make(
            center=(c + np.array([0.0, -1.0, 0.5])).tolist(), radius=1.0,
            color=(0.8, 0.8, 0.8), roughness=0.3, device=device))
    return attach_atmosphere(s, cache_path=GOLDEN_LUTS,
                             dims=LutDims(**TINY_DIMS))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["atmosphere", "sky_cache"])
def test_k4_atmosphere_kinds_match_plain(cuda_device, kind):
    """K4's ATMOSPHERE and SKY_CACHE kinds on K1's retired rays against
    L + environment_radiance(pos, dir) * beta on the card: ATMOSPHERE bit
    for bit, SKY_CACHE within 2e-6 (the tonemapped output lies in [0,
    1])."""
    from vpt_tpu_torch.render import integrator
    from vpt_tpu_torch.scene.scene import attach_sky_cache
    s = _atmosphere_scene(cuda_device)
    if kind == "sky_cache":
        s = attach_sky_cache(s, 150.0, 30.0, 32, 64)
    p = RenderParams(width=48, height=40, shadow_mode="tracked",
                     environment_type=0, ray_depth=8, sky_mult=0.7)
    key = rng.render_key(0, 5)
    o, d = renderer._primary_rays_cuda(s.camera, p, key)
    launch = fused.prepare_fused(s, p)
    views = fused._launch_k1(launch, renderer.tile_key(key), o, d)
    pos = views[7] if kind == "atmosphere" else None
    assert (len(views) == 8) == (kind == "atmosphere")
    want = views[0] + integrator.environment_radiance(
        s, p, views[6] if pos is None else pos, views[6]) * views[5]
    got = integrator.add_environment(s, p, views[0].clone(), views[5],
                                     views[6], pos, launch=launch.env)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    if kind == "atmosphere":
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        assert float((got - want).abs().max()) <= 2e-6


def _k4_atmosphere(device, dims):
    """The golden's tiny LUTs, or LUTs at the full LutDims of seeded
    uniform values (the kernel's lookups do not depend on what the
    texels hold)."""
    from vpt_tpu_torch.sky import bruneton as br
    from vpt_tpu_torch.sky import runtime as rt
    if dims == "tiny":
        return rt.make_atmosphere(br.LutDims(**TINY_DIMS),
                                  cache_path=GOLDEN_LUTS, device=device)
    d, r = br.LutDims(), np.random.default_rng(3)
    luts = br.AtmosphereLUTs(**{
        n: torch.as_tensor(r.uniform(0.0, 1.0, s).astype(np.float32),
                           device=device) for n, s in d.shapes().items()})
    return rt.Atmosphere(br.default_model(device=device), luts, d)


def _k4_rays(kind, n, device, seed=0):
    """Seeded (pos, dir) on the card: positions in the upper part of
    config 4's box (2-6.4 m above the ground: a ray from a few
    centimetres up meets the ground sphere at a distance that float32
    rounds to 0 at r ~ 6.4e6 m, which counts as no hit), directions down
    (every ray to the ground), up (every ray to the sky), or alternating
    lane by lane."""
    r = np.random.default_rng(seed)
    pos = r.uniform(0.0, 6.4, (n, 3)).astype(np.float32)
    pos[:, 1] = r.uniform(2.0, 6.4, n)
    d = r.normal(size=(n, 3))
    down = {"ground": np.ones(n, bool), "sky": np.zeros(n, bool),
            "alternate": np.arange(n) % 2 == 0}[kind]
    d[:, 1] = np.where(down, -1.0, 1.0) * (np.abs(d[:, 1]) + 0.05)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(pos, device=device),
            torch.as_tensor(d.astype(np.float32), device=device), down)


@pytest.fixture(scope="module")
def k4_atmospheres():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    return {dims: _k4_atmosphere(dev, dims) for dims in ("tiny", "full")}


@pytest.mark.cuda
@pytest.mark.parametrize("dims", ["tiny", "full"])
@pytest.mark.parametrize("rays,n", [
    ("ground", 4096), ("sky", 4096), ("alternate", 4096), ("space", 4096),
    ("alternate", 1), ("alternate", 1000)])
def test_k4_atmosphere_bit_for_bit(k4_atmospheres, dims, rays, n):
    """K4's ATMOSPHERE kind against L + environment_radiance(pos, dir) *
    beta on the card, bit for bit on every ray: rays all to the ground,
    all to the sky, alternating lane by lane (every warp in ray order
    holds both branches), from space, one ray, and a count no block
    size divides; one launch, on the atmosphere's packed LUTs."""
    import types

    from vpt_tpu_torch.render import integrator
    from vpt_tpu_torch.sky import runtime as rt
    atm = k4_atmospheres[dims]
    dev = atm.luts.transmittance.device
    if rays == "space":
        pos, d = rt.earth_rays(atm.params, 64, 64)
        pos, d = pos[:n].contiguous(), d[:n].contiguous()
    else:
        pos, d, down = _k4_rays(rays, n, dev)
        assert np.array_equal(
            rt.ground_hit(atm.params, pos, d)[3].cpu().numpy(), down)
    scene = types.SimpleNamespace(atmosphere=atm, sky_cache=None,
                                  env_map=None)
    p = RenderParams(width=8, height=8, environment_type=0, sky_mult=0.7,
                     sky_color=(0.9, 1.0, 1.1))
    g = torch.Generator(device="cpu").manual_seed(4)
    L = torch.rand((n, 3), generator=g).to(dev)
    beta = torch.rand((n, 3), generator=g).to(dev)
    want = L + integrator.environment_radiance(scene, p, pos, d) * beta
    before = integrator.ENVIRONMENT_ATMOSPHERE.launches
    got = integrator.add_environment(scene, p, L.clone(), beta, d, pos)
    torch.cuda.synchronize()
    assert integrator.ENVIRONMENT_ATMOSPHERE.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_k4_atmosphere_schedule_and_packed_luts(k4_atmospheres):
    """The ATMOSPHERE kind runs 256 threads a block at 5 or more blocks
    an SM (48 registers or fewer), and prepare_environment launches it on
    the atmosphere's packed LUTs, the same tensors every time."""
    import types

    from vpt_tpu_torch.render import integrator
    atm = k4_atmospheres["tiny"]
    scene = types.SimpleNamespace(atmosphere=atm, sky_cache=None,
                                  env_map=None)
    p = RenderParams(width=8, height=8, environment_type=0)
    launch = integrator.prepare_environment(scene, p)
    assert launch.atm.scat_mie == atm.k4_luts.scattering_mie.data_ptr()
    assert integrator.prepare_environment(scene, p).atm.scat_mie == \
        launch.atm.scat_mie
    info = integrator.atmosphere_launch_info()
    assert info["threads"] == 256 and info["blocks_per_sm"] >= 5
    assert info["registers"] <= 48


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cached", "tracked"])
def test_k1_env_pos_matches_plain(cuda_device, mode):
    """K1's DEFER 2 variant writes the plain loop's env_pos bit for bit
    on every ray whose outputs are the plain loop's; a sphere's events
    move it off the origin."""
    s = _atmosphere_scene(cuda_device, sphere=True)
    p = RenderParams(width=48, height=40, shadow_mode=mode,
                     environment_type=0, ray_depth=8)
    key = rng.render_key(0, 6)
    o, d = renderer._primary_rays_cuda(s.camera, p, key)
    tkey = renderer.tile_key(key)
    launch = fused.prepare_fused(s, p)
    assert launch.params.defer_env == 2
    views = fused._launch_k1(launch, tkey, o, d)
    plain = fused.fused_direct_plain(s, p, tkey, o, d, deferred=True)
    torch.cuda.synchronize()
    same = torch.ones(o.shape[0], dtype=torch.bool, device=cuda_device)
    for a, b in zip(views[:7], plain[:7]):
        eq = a.contiguous().view(torch.int32) == b.contiguous().view(
            torch.int32)
        same &= eq.all(-1) if eq.dim() == 2 else eq
    env = (views[7].view(torch.int32) == plain[7].view(torch.int32)).all(-1)
    assert float(same.double().mean()) >= 0.99
    assert bool(env[same].all())
    assert bool((plain[7] != o).any())


@pytest.mark.cuda
@pytest.mark.parametrize("in_kernel", [False, True])
def test_k1_env_pos_queued_cut_matches_plain(cuda_device, in_kernel):
    """K1's DEFER 2 at queue 16 with the walk cut short (16 steps in a 32
    times denser blob), on the buffer route and the in-kernel-ray route:
    every output, beta, direction and env_pos of the plain loop's on
    every ray whose outputs agree, and some slots cut, their env_pos the
    primary origin."""
    s = _atmosphere_scene(cuda_device, sphere=True)
    p = RenderParams(width=48, height=40, shadow_mode="cached",
                     environment_type=0, ray_depth=8, max_fused_steps=1,
                     density_mult=32.0)
    key = rng.render_key(0, 7)
    o, d = renderer._primary_rays_cuda(s.camera, p, key)
    tkey = renderer.tile_key(key)
    launch = fused.prepare_fused(s, p)
    assert launch.params.defer_env == 2
    if in_kernel:
        raygen = renderer._raygen_for_sample(
            renderer.prepare_raygen(s.camera, p), key)
        views = fused._launch_k1_primary(launch, tkey, raygen, 16)
    else:
        views = fused._launch_k1(launch, tkey, o, d, p.width, 16)
    plain = fused.fused_direct_plain(s, p, tkey, o, d, 16, deferred=True)
    torch.cuda.synchronize()
    same = torch.ones(o.shape[0], dtype=torch.bool, device=cuda_device)
    for a, b in zip(views[:7], plain[:7]):
        eq = a.contiguous().view(torch.int32) == b.contiguous().view(
            torch.int32)
        same &= eq.all(-1) if eq.dim() == 2 else eq
    env = (views[7].view(torch.int32) == plain[7].view(torch.int32)).all(-1)
    cut = plain[3] == 1.0
    assert float(same.double().mean()) >= 0.99
    assert bool(env[same].all())
    assert bool(cut.any()) and bool((plain[7][cut] == o[cut]).all())


@pytest.mark.cuda
def test_earth_on_the_card_matches_plain(cuda_device):
    from vpt_tpu_torch.render import integrator
    from vpt_tpu_torch.sky import runtime as rt
    from vpt_tpu_torch.sky.bruneton import LutDims
    atm = rt.make_atmosphere(LutDims(**TINY_DIMS), cache_path=GOLDEN_LUTS,
                             device=cuda_device)
    before = integrator.ENVIRONMENT_ATMOSPHERE.launches
    img = rt.render_earth(atm, 64, 48)
    assert integrator.ENVIRONMENT_ATMOSPHERE.launches == before + 1
    pos, dirs = rt.earth_rays(atm.params, 64, 48)
    want = rt.sample_atmosphere(atm, pos, dirs, 150.0, 30.0, atm.dims)
    assert torch.equal(img.reshape(-1, 3).view(torch.int32),
                       want.view(torch.int32))


# K1's instances of a single grid's rows: build_scene's options, and the
# counter beside the route's that a launch on them adds to
ROW_CASES = {"bf16": dict(corner_dtype="bfloat16"),
             "bf16_octant": dict(corner_dtype="bfloat16", octant_boxes=True),
             "f32_octant": dict(octant_boxes=True)}


def _rows_counter(rows):
    return (fused.FUSED_DIRECT_OCTANT if rows == "f32_octant"
            else fused.FUSED_DIRECT_BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", list(ROW_CASES))
@pytest.mark.parametrize("env", ["black", "sky", "atmosphere"])
@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("mode", ["cached", "tracked"])
def test_k1_row_instances_match_plain(cuda_device, mode, ext, env, rows):
    """K1's bfloat16 and octant instances (density only and EXT, DEFER 0,
    1 and 2) on both routes against the plain loop by the share rule, the
    in-kernel-ray route bit for bit the buffer route, env_pos the plain
    loop's wherever the outputs are; each launch counted once on the
    rows' counter and never on the other."""
    kw = dict(ROW_CASES[rows], emission=ext)
    s = (_atmosphere_scene(cuda_device, **kw) if env == "atmosphere"
         else _blob_scene(cuda_device, **kw))
    p = RenderParams(width=48, height=40, shadow_mode=mode,
                     environment_type={"black": 2, "sky": 0,
                                       "atmosphere": 0}[env],
                     ray_depth=8, emission_scale=1.5)
    key = rng.render_key(0, 7)
    o, d = renderer._primary_rays_cuda(s.camera, p, key)
    tkey = renderer.tile_key(key)
    counter, other = _rows_counter(rows), (
        fused.FUSED_DIRECT_BF16 if rows == "f32_octant"
        else fused.FUSED_DIRECT_OCTANT)
    before = (counter.launches, other.launches)
    launch = fused.prepare_fused(s, p)
    assert launch.params.defer_env == {"black": 0, "sky": 1,
                                       "atmosphere": 2}[env]
    views = fused._launch_k1(launch, tkey, o, d)
    buf = fused._finish(s, p, launch, views)
    gen = renderer._trace_primary_cuda(s, p, key)
    torch.cuda.synchronize()
    assert (counter.launches, other.launches) == (before[0] + 2, before[1])
    assert _same_bits(gen, buf)
    plain = fused.fused_direct_plain(s, p, tkey, o, d, deferred=True)
    ref = fused.fused_direct_plain(s, p, tkey, o, d)
    share, rel = agreement([x.cpu().numpy() for x in buf],
                           [x.cpu().numpy() for x in ref])
    assert share >= 0.99 and rel <= 0.005, (share, rel)
    assert float(ref[0].mean()) > 0.0
    if env == "atmosphere":
        # L took K4's term in place: the other outputs, beta and direction
        same = torch.ones(o.shape[0], dtype=torch.bool, device=cuda_device)
        for a, b in zip(views[1:7], plain[1:7]):
            eq = a.contiguous().view(torch.int32) == b.contiguous().view(
                torch.int32)
            same &= eq.all(-1) if eq.dim() == 2 else eq
        env_same = (views[7].view(torch.int32)
                    == plain[7].view(torch.int32)).all(-1)
        assert bool(env_same[same].all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", list(ROW_CASES))
def test_k1_row_instances_launch_info(cuda_device, rows):
    """Every instance a launch can reach reports its schedule."""
    from vpt_tpu_torch.ops import cuda
    kind = cuda.row_kind(
        torch.bfloat16 if rows.startswith("bf16") else torch.float32,
        72 if rows.endswith("octant") else 0)
    for in_kernel in (False, True):
        for defer in (0, 1, 2):
            for ext in (False, True):
                info = fused.launch_info(in_kernel, 128, defer, ext,
                                         rows=kind)
                assert info["blocks_per_sm"] >= 1 and info["registers"] > 0


def test_row_kind_picks_the_instances():
    """ops/cuda.py::row_kind on the rows K1 takes, and a refusal on
    others (no card needed)."""
    from vpt_tpu_torch.ops import cuda
    assert cuda.row_kind(torch.float32, 0) == cuda.ROWS_F32
    assert cuda.row_kind(torch.float32, 72) == cuda.ROWS_F32_OCTANT
    assert cuda.row_kind(torch.bfloat16, 0) == cuda.ROWS_BF16
    assert cuda.row_kind(torch.bfloat16, 72) == cuda.ROWS_BF16_OCTANT
    with pytest.raises(ValueError):
        cuda.row_kind(torch.float16, 0)
    src = open(os.path.join(CSRC, "fused_direct.cu")).read()
    m = re.search(r"constexpr int ROWS_F32 = (\d), ROWS_F32_OCTANT = (\d), "
                  r"ROWS_BF16 = (\d),\s+ROWS_BF16_OCTANT = (\d);", src)
    assert m and [int(v) for v in m.groups()] == [
        cuda.ROWS_F32, cuda.ROWS_F32_OCTANT, cuda.ROWS_BF16,
        cuda.ROWS_BF16_OCTANT]


# K5's cases: the environment (and, for the volumetric integrator's sky
# estimate, whether the CDF strategy runs) on the blob, density-only or
# EXT (emission, color, volume_depth 2)
K5_ENVS = {"black": dict(environment_type=2),
           "constant": dict(environment_type=3, sky_mult=0.5),
           "sky": dict(environment_type=0),
           "sky_cdf": dict(environment_type=0),
           "hdri": dict(environment_type=1),
           "hdri_cdf": dict(environment_type=1, hdri_importance=True)}


def _k5_scene(device, env, ext):
    from vpt_tpu_torch.scene.scene import attach_env_map, attach_sky_cdf
    from vpt_tpu_torch.tools.common import c3_map
    s = _blob_scene(device, emission=ext, color=ext)
    if env.startswith("hdri"):
        s = attach_env_map(s, c3_map(32, 64))
    if env == "sky_cdf":
        s = attach_sky_cdf(s)
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("env", list(K5_ENVS))
@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("volumetric", [False, True])
def test_k5_matches_plain(cuda_device, volumetric, ext, env):
    """K5 (and K4 after it) against the plain integrator on the card by
    the share rule, in several tiles of 1000 rays, each launch counted."""
    from vpt_tpu_torch.render.integrator import direct_integrator_plain
    from vpt_tpu_torch.render.vol_integrator import vol_integrator_plain
    s = _k5_scene(cuda_device, env, ext)
    p = RenderParams(width=48, height=40, ray_depth=6, max_track_steps=128,
                     volume_depth=2 if ext else 1, emission_scale=2.0,
                     phase_g1=0.3, **K5_ENVS[env])
    key = rng.render_key(0, 2)
    o, d = renderer._primary_rays_cuda(s.camera, p, key)
    counter = walk.WALK_VOLUMETRIC if volumetric else walk.WALK_DIRECT
    before = counter.launches
    run = walk.walk_volumetric if volumetric else walk.walk_direct
    got = run(s, p, key, o, d, tile=1000)
    assert counter.launches == before + 1
    plain = vol_integrator_plain if volumetric else direct_integrator_plain
    want = [torch.cat(parts) for parts in zip(*(
        plain(s, p, rng.fold_in(key, 1000 + t), o[a:a + 1000],
              d[a:a + 1000]) for t, a in enumerate(range(0, o.shape[0],
                                                          1000))))]
    share, rel = agreement([x.cpu().numpy() for x in got],
                           [x.cpu().numpy() for x in want])
    assert share >= 0.99 and rel <= 0.005, (share, rel)
    assert float(want[0].mean()) > 0.0
    assert torch.equal(got[3], torch.zeros_like(got[3]))


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", [0, 1])
def test_k5_renders_through_the_renderer(cuda_device, integrator):
    """ProgressiveRenderer with engine="reference" (or the volumetric
    integrator) launches K5 and K3 once a sample and K1 never."""
    s = _k5_scene(cuda_device, "sky", False)
    p = RenderParams(width=32, height=24, ray_depth=4, engine="reference",
                     integrator=integrator, environment_type=0)
    kernels = ((walk.WALK_VOLUMETRIC if integrator else walk.WALK_DIRECT),
               tfilm.FILM_ACCUMULATE, fused.FUSED_DIRECT,
               fused.FUSED_DIRECT_PRIMARY)
    before = [k.launches for k in kernels]
    r = renderer.ProgressiveRenderer(s, p)
    r.render(3)
    assert [k.launches - b for k, b in zip(kernels, before)] == [3, 3, 0, 0]
    assert torch.isfinite(r.film.accum).all() and float(
        r.film.accum.mean()) > 0


def _k5_kind_scene(device, case):
    """K5's scene and sky kinds beyond float32 rows without octant columns
    under the run-time sky: a single grid in float32 rows with the octant
    columns, in bfloat16 rows with and without them; 12 instances (cell
    lists) and 4 (the static loop) of two grids; each density-only and
    EXT (emission and color); the Bruneton atmosphere (the golden tiny
    LUTs) live and baked, on the bfloat16 blob and on the cell lists."""
    from vpt_tpu_torch.scene.scene import attach_atmosphere, attach_sky_cache
    from vpt_tpu_torch.sky.bruneton import LutDims
    ext = case.endswith("_ext")
    kind = case[:-4] if ext else case
    bf16 = dict(corner_dtype="bfloat16", octant_boxes=True)
    if kind == "octant":
        return _blob_scene(device, emission=ext, color=ext, octant_boxes=True)
    if kind == "bf16":
        return _blob_scene(device, emission=ext, color=ext, **bf16)
    if kind == "bf16_no_octant":
        return _blob_scene(device, emission=ext, color=ext,
                           corner_dtype="bfloat16")
    if kind in ("cells", "loop"):
        return _loop_scene(device, ext, 12 if kind == "cells" else 4)
    s = (_loop_scene(device, False, 12) if kind.endswith("cells")
         else _blob_scene(device, **bf16))
    s = attach_atmosphere(s, cache_path=GOLDEN_LUTS,
                          dims=LutDims(**TINY_DIMS))
    if kind.startswith("sky_cache"):
        s = attach_sky_cache(s, 150.0, 30.0, 32, 64)
    return s


# (case, volumetric): the former refusals first (an instanced scene,
# bfloat16 rows, octant columns, the volumetric integrator's sky NEE under
# the Bruneton atmosphere), then every other kind
K5_KIND_CASES = [("loop", False), ("bf16", False), ("octant", False),
                 ("atmosphere", True)] + [
    (c, v) for c in ("octant_ext", "bf16_ext", "bf16_no_octant", "cells",
                     "cells_ext", "loop_ext") for v in (False, True)] + [
    ("loop", True), ("bf16", True), ("octant", True), ("sky_cache", True),
    ("atmosphere_cells", True), ("sky_cache_cells", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,volumetric", K5_KIND_CASES)
def test_k5_scene_kinds_bit_for_bit(cuda_device, case, volumetric):
    """Each K5 instance beyond float32 rows without octant columns under
    the run-time sky launches on its scene and writes the plain
    integrator's bits at a ragged 37 x 29 in tiles of 400, every stage's
    instance counted under its name."""
    s = _k5_kind_scene(cuda_device, case)
    key = rng.render_key(13, 2)
    kw = dict(environment_type=0, emission_scale=2.0)
    if case.endswith("_ext"):
        kw["volume_depth"] = 2
    p, o, d = _k5_rays(s, 37, 29, key, **kw)
    launch = walk.prepare_walk(s, p, volumetric)
    names = walk.instance_names(volumetric, launch.ext, launch.scene.kind,
                                launch.scene.sky)
    assert names
    before = {n: walk.variant(n, k, launch.scene.kind).launches
              for k, n in names.items()}
    run = walk.walk_volumetric if volumetric else walk.walk_direct
    got = run(s, p, key, o, d, launch=launch, tile=400)
    _assert_bits(got, _k5_plain_tiles(s, p, volumetric, key, o, d, 400))
    assert float(got[0].mean()) > 0.0
    for k, n in names.items():
        assert walk.VARIANTS[n].launches > before[n], n


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bfloat16", "octant"])
def test_k5_out_of_scope_raises_before_launch(cuda_device, case):
    """What K5 does not take raises NotImplementedError before any launch,
    naming its ROADMAP item; nothing falls back to a plain version: an
    instanced scene in bfloat16 rows or with octant columns in its corner
    rows (build_scene refuses both, ROADMAP A.10; made here by
    swapping a single grid's atlas in)."""
    s = _loop_scene(cuda_device, False)
    rows = _blob_scene(cuda_device, corner_dtype=(
        "bfloat16" if case == "bfloat16" else "float32"),
        octant_boxes=case == "octant").atlas
    s = dataclasses.replace(s, atlas=rows)
    p = RenderParams(width=16, height=16, ray_depth=2, environment_type=0,
                     engine="reference")
    o, d = renderer._primary_rays_cuda(s.camera, p, rng.render_key(0, 0))
    before = (walk.WALK_DIRECT.launches, walk.WALK_VOLUMETRIC.launches)
    for run in (walk.walk_direct, walk.walk_volumetric):
        with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
            run(s, p, (0, 1), o, d)
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        renderer.ProgressiveRenderer(s, p)
    assert (walk.WALK_DIRECT.launches,
            walk.WALK_VOLUMETRIC.launches) == before


@pytest.mark.cuda
def test_k5_launch_info(cuda_device):
    for volumetric in (False, True):
        for ext in (False, True):
            info = walk.launch_info(volumetric, ext)
            assert info["threads"] == 128 and info["blocks_per_sm"] >= 1


def _k5_plain_tiles(s, p, volumetric, key, o, d, tile):
    """The plain integrator over the launch's tiles (tile 0: one tile
    under ``key``), concatenated."""
    from vpt_tpu_torch.render.integrator import direct_integrator_plain
    from vpt_tpu_torch.render.vol_integrator import vol_integrator_plain
    plain = vol_integrator_plain if volumetric else direct_integrator_plain
    if tile == 0:
        return plain(s, p, key, o, d)
    return [torch.cat(parts) for parts in zip(*(
        plain(s, p, rng.fold_in(key, 1000 + t), o[a:a + tile], d[a:a + tile])
        for t, a in enumerate(range(0, o.shape[0], tile))))]


def _assert_bits(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))


def _k5_rays(s, w, h, key, **kw):
    p = RenderParams(width=w, height=h, ray_depth=6, max_track_steps=128,
                     phase_g1=0.3, **kw)
    o, d = renderer._primary_rays_cuda(s.camera, p, key)
    return p, o, d


# (B = w * h, tile): B not a multiple of 128 in one tile, B below one
# tile, several tiles with a ragged last one
K5_SHAPES = {"one_tile": (37, 29, 0), "below_tile": (37, 29, 2000),
             "ragged_tiles": (37, 29, 400)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(K5_SHAPES))
@pytest.mark.parametrize("volumetric", [False, True])
def test_k5_bit_for_bit_shapes(cuda_device, volumetric, shape):
    """K5's new schedules write the plain version's bits at any B and
    tiling: the tile and the index in it come from the ray index, never
    from a queue slot."""
    w, h, tile = K5_SHAPES[shape]
    s = _k5_scene(cuda_device, "sky", False)
    key = rng.render_key(3, 1)
    p, o, d = _k5_rays(s, w, h, key, environment_type=0)
    run = walk.walk_volumetric if volumetric else walk.walk_direct
    got = run(s, p, key, o, d, tile=tile)
    _assert_bits(got, _k5_plain_tiles(s, p, volumetric, key, o, d, tile))
    assert float(got[0].mean()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_miss", "ray_depth_1", "ext",
                                  "repeat"])
@pytest.mark.parametrize("volumetric", [False, True])
def test_k5_bit_for_bit_cases(cuda_device, volumetric, case):
    """Every ray missing the box (every queue empty), ray_depth 1, EXT
    with emission and color, and two launches giving the same bits."""
    ext = case == "ext"
    s = _k5_scene(cuda_device, "constant", ext)
    key = rng.render_key(5, 2)
    kw = dict(environment_type=3, sky_mult=0.5)
    if ext:
        kw.update(volume_depth=2, emission_scale=2.0)
    p, o, d = _k5_rays(s, 40, 30, key, **kw)
    if case == "all_miss":
        d = -d
    if case == "ray_depth_1":
        p = p.replace(ray_depth=1)
    run = walk.walk_volumetric if volumetric else walk.walk_direct
    launch = walk.prepare_walk(s, p, volumetric)
    got = run(s, p, key, o, d, launch=launch, tile=500)
    _assert_bits(got, _k5_plain_tiles(s, p, volumetric, key, o, d, 500))
    if case == "repeat":
        _assert_bits(run(s, p, key, o, d, launch=launch, tile=500), got)
    if case == "all_miss":
        assert float(got[2].abs().sum()) == 0.0
        if volumetric:
            q = walk.queue_lengths(launch)
            assert sum(q["scatter"]) == 0 and sum(q["live"][1:]) == 0


@pytest.mark.cuda
def test_k5_volumetric_all_nee_kinds(cuda_device):
    """A launch whose paths take the sun, the point lights and the sky
    (the three kinds of its NEE kernel), bit for bit, each stage kernel
    counted once a bounce."""
    s = _k5_scene(cuda_device, "sky_cdf", False)
    key = rng.render_key(7, 0)
    p, o, d = _k5_rays(s, 40, 32, key, environment_type=0)
    launch = walk.prepare_walk(s, p, True)
    kernels = walk.LAUNCH_KINDS
    before = [k.launches for k in kernels]
    got = walk.walk_volumetric(s, p, key, o, d, launch=launch, tile=512)
    q = walk.queue_lengths(launch)
    assert min(sum(q["sun"]), sum(q["point"]), sum(q["sky"])) > 0
    _assert_bits(got, _k5_plain_tiles(s, p, True, key, o, d, 512))
    added = dict(zip(walk.STAGES, (k.launches - b
                                   for k, b in zip(kernels, before))))
    assert added == dict(keys=p.ray_depth, direct=0, extend=p.ray_depth,
                         nee=p.ray_depth, scatter=p.ray_depth)


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric", [False, True])
def test_k5_timed_launch(cuda_device, volumetric):
    """A launch timed by kernel_ms writes the untimed launch's bits, and
    gives every kernel it launched a device time above 0."""
    s = _k5_scene(cuda_device, "sky", False)
    key = rng.render_key(3, 1)
    p, o, d = _k5_rays(s, 40, 30, key, environment_type=0)
    launch = walk.prepare_walk(s, p, volumetric)
    want = [v.clone() for v in walk._launch_k5(launch, key, o, d, 500)]
    before = {k.name: k.launches for k in walk.LAUNCH_KINDS}
    ms = {}
    got = walk._launch_k5(launch, key, o, d, 500, kernel_ms=ms)
    _assert_bits(got, want)
    for k in walk.LAUNCH_KINDS:
        assert (ms[k.name] > 0.0) == (k.launches > before[k.name])


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric", [False, True])
@pytest.mark.parametrize("env", ["sky", "hdri_cdf"])
def test_k5_key_table_matches_plain(cuda_device, volumetric, env):
    """walk_keys_kernel's table equals key_table_plain bit for bit (three
    tiles, two bounces), with two HG lobes and two point lights."""
    s = _k5_scene(cuda_device, env, False)
    s = dataclasses.replace(s, lights=PointLights.make(
        [[2.0, 3.0, 4.0], [-2.0, 3.0, 1.0]], [[1, 1, 1], [1, 0.5, 0.5]],
        [30.0, 10.0], device=cuda_device))
    p = RenderParams(width=16, height=16, ray_depth=3, max_track_steps=40,
                     use_double_hg=True, phase_g2=-0.2, phase_f=0.7,
                     **K5_ENVS[env])
    launch = walk.prepare_walk(s, p, volumetric)
    key = rng.render_key(11, 4)
    layout = walk.launch_layout(launch)
    for d0 in (0, 1):
        got = walk.key_table(launch, key, 700, 256, d0)
        want = walk.key_table_plain(layout, key, 3, 256, d0,
                                    got.shape[1], cuda_device)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_k5_stage_launch_info(cuda_device):
    """Registers, local bytes and resident blocks of every K5 kernel: the
    stage kernels at 8 blocks of 128 an SM or more where the compiler
    allows it (PERF.md records them)."""
    for stage in walk.STAGES:
        for ext in (False, True):
            for sc in range(len(walk.SCENE_TAGS)):
                skies = (range(len(walk.SKY_TAGS)) if stage == "nee"
                         else (0,))
                for sky in skies:
                    info = walk.launch_info(stage != "direct", ext, stage,
                                            sc, sky)
                    assert (info["threads"] == 128
                            and info["blocks_per_sm"] >= 1)


@pytest.fixture(scope="module")
def walk_main_scene():
    """tools/time_walk.py's main scene (the procedural 200^3 grid, one
    point light, the sun), built once for its parity cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    from vpt_tpu_torch.tools import time_walk
    return time_walk.main_scene(torch.device("cuda", 0))


# tools/time_walk.py's parity cases: the reference engine's two, the
# volumetric integrator's three, and its point-light case
TIME_WALK_CASES = [(False, "density"), (False, "ext_config2_f32"),
                   (True, "sky"), (True, "hdri_cdf"),
                   (True, "ext_config2_f32"), (True, "sky_point")]


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric,case", TIME_WALK_CASES)
def test_k5_time_walk_parity_cases(cuda_device, walk_main_scene, volumetric,
                                   case):
    """The chip_smoke.py phases' parity cases at 256^2, every ray bit for
    bit with the plain integrator (time_walk.parity's bit_share)."""
    from vpt_tpu_torch.tools import time_walk
    scene, p = time_walk.parity_cases(cuda_device, walk_main_scene,
                                      volumetric)[case]
    m = time_walk.parity(scene, p, cuda_device, volumetric)
    assert m["bit_share"] == 1.0 and m["mean"] > 0.0, m
