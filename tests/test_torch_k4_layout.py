"""K4's layout of the Bruneton LUTs (sky/runtime.py::pack_k4_luts) and
the ground decision that picks each ray's branch in K4
(sky/runtime.py::ground_hit), on the CPU at the golden's tiny LUT dims.

The layout is held texel by texel, bit for bit, through the flat
indices csrc/environment.cu computes; the decision against the
reference's own hits_ground (vpt_tpu/sky/runtime.py:104-115, run in JAX
on the same seeded rays).  The kernel itself is held bit for bit to its
plain version on the card (tests/test_torch_cuda.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_golden import GOLDEN_DIR
from vpt_tpu.core.vecmath import normalize as j_normalize
from vpt_tpu.sky import bruneton as jb
from vpt_tpu_torch.sky import bruneton as tb
from vpt_tpu_torch.sky import runtime as tr

TINY = dict(transmittance_w=64, transmittance_h=16, r=4, mu=32, mu_s=8, nu=4,
            irradiance_w=16, irradiance_h=4)
GOLDEN_LUTS = f"{GOLDEN_DIR}/tiny_luts.npz"


@pytest.fixture(scope="module")
def atm():
    return tr.make_atmosphere(tb.LutDims(**TINY), cache_path=GOLDEN_LUTS,
                              device="cpu")


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_k4_layout_holds_every_texel(atm):
    """Each texel at the flat float offset the kernel reads it from:
    transmittance and irradiance 4 (y * W + x), the scattering 8 ((z * H
    + y) * W + x) and the single Mie 4 past it; zeros between; contiguous
    float32 of the shapes the kernel assumes."""
    luts, k4 = atm.luts, atm.k4_luts
    d = tb.LutDims(**TINY)
    shapes = dict(transmittance=(d.transmittance_h, d.transmittance_w, 4),
                  irradiance=(d.irradiance_h, d.irradiance_w, 4),
                  scattering_mie=(d.r, d.mu, d.scattering_w, 8))
    for name, shape in shapes.items():
        t = getattr(k4, name)
        assert tuple(t.shape) == shape and t.dtype == torch.float32
        assert t.is_contiguous()
    for name in ("transmittance", "irradiance"):
        flat, src = getattr(k4, name).reshape(-1), getattr(luts, name)
        h, w = src.shape[:2]
        y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        i = torch.as_tensor(4 * (y * w + x)).reshape(-1)
        for c in range(3):
            assert torch.equal(_bits(flat[i + c]),
                               _bits(src[..., c].reshape(-1)))
        assert not bool(_bits(flat[i + 3]).any())
    flat = k4.scattering_mie.reshape(-1)
    D, H, W = d.r, d.mu, d.scattering_w
    z, y, x = np.meshgrid(np.arange(D), np.arange(H), np.arange(W),
                          indexing="ij")
    i = torch.as_tensor(8 * ((z * H + y) * W + x)).reshape(-1)
    for off, src in ((0, luts.scattering), (4, luts.single_mie)):
        for c in range(3):
            assert torch.equal(_bits(flat[i + off + c]),
                               _bits(src[..., c].reshape(-1)))
        assert not bool(_bits(flat[i + off + 3]).any())
    assert k4.nbytes == 4 * (16 * 64 * 4 + 4 * 16 * 4 + 4 * 32 * 32 * 8)


def test_k4_layout_is_packed_once_per_atmosphere(atm):
    """atm.k4_luts is packed at first use and kept, and moving an
    atmosphere to the device it is on keeps it (attach_atmosphere does)."""
    k4 = atm.k4_luts
    assert atm.k4_luts is k4
    assert atm.to("cpu") is atm and atm.to("cpu").k4_luts is k4
    other = tr.Atmosphere(atm.params, atm.luts, atm.dims)
    assert other.k4_luts is not k4


def _j_hits_ground(p, pos, view):
    """vpt_tpu/sky/runtime.py:104-115, the reference's ground hit, on
    numpy positions and unit directions ``view`` (the reference's
    ``normalize(ray_dir)``)."""
    earth_center = jnp.array([0.0, 1.0, 0.0], jnp.float32) * p.earth_center_y
    camera = jnp.asarray(pos) - earth_center
    view = jnp.asarray(view)
    p_dot_v = jnp.sum(camera * view, axis=-1)
    p_dot_p = jnp.sum(camera * camera, axis=-1)
    disc = p.bottom_radius ** 2 - (p_dot_p - p_dot_v * p_dot_v)
    dist = -p_dot_v - jnp.sqrt(jnp.maximum(disc, 0.0))
    return np.asarray((dist > 0.0) & (disc >= 0.0))


def _rays(kind, n=2048, seed=0):
    """Seeded (pos, dir): from 0.5-50 m above the ground, from config 4's
    box and camera (the 64^3 puff of 0.1 voxels, the camera 9 in front and
    0.5 above its centre), grazing (within 2e-3 of the horizon), or from
    space (render_earth's camera)."""
    r = np.random.default_rng(seed)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = np.zeros((n, 3), np.float32)
    if kind == "ground":
        pos[:, 1] = r.uniform(0.5, 50.0, n)
        pos[:, [0, 2]] = r.uniform(-1e3, 1e3, (n, 2))
    elif kind == "config4":
        pos[:] = r.uniform(0.0, 6.4, (n, 3))
        pos[: n // 4] = (3.2, 3.7, 12.2)
    elif kind == "grazing":
        pos[:, 1] = r.uniform(1.0, 10.0, n)
        d[:, 1] = r.uniform(-2e-3, 2e-4, n)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return pos, d.astype(np.float32)


@pytest.mark.parametrize("kind", ["ground", "config4", "grazing", "space"])
def test_ground_hit_matches_reference(atm, kind):
    """The port's one ground decision (which K4's ATMOSPHERE kind makes
    to pick each ray's branch) equals the reference's hits_ground on
    every ray, both taking the port's unit direction: on a CPU, XLA's
    rsqrt and torch's differ in the last bit for about a third of these
    directions, which moves the decision of a ray a few centimetres
    above the ground (1 of config 4's 2048); on the card both
    normalizations are rsqrtf.  The directions themselves agree to an
    ulp."""
    if kind == "space":
        pos, d = (t.numpy() for t in tr.earth_rays(atm.params, 48, 40))
    else:
        pos, d = _rays(kind)
    camera, view, dist, got = tr.ground_hit(
        atm.params, torch.as_tensor(pos), torch.as_tensor(d))
    want = _j_hits_ground(jb.default_model(), pos, view.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 < want.mean() < 1.0
    np.testing.assert_allclose(view.numpy(), np.asarray(j_normalize(
        jnp.asarray(d))), rtol=0, atol=2.5e-7)


def test_mixed_warp_share():
    """A warp holds both branches where its rays' ground hits differ; the
    last warp counts its own rays only."""
    g = torch.zeros(32 * 3 + 5, dtype=torch.bool)
    g[3] = True                  # warp 0 mixed
    g[32:64] = True              # warp 1 all ground
    g[96:101] = True             # the short last warp: all ground
    from vpt_tpu_torch.tools.common import mixed_warp_share
    assert mixed_warp_share(g) == 0.25
    assert mixed_warp_share(g[:32]) == 1.0


def test_k4_layout_bytes_at_full_dims():
    """At the CLI's full LutDims the K4 layout holds 33.5 MB of 4-D
    texels plus 0.28 MB of 2-D ones, every table contiguous and
    32-byte rows; the (..., 3) LUTs, which the kernel's bound counts,
    keep their 25.5 MB and gain no field."""
    d = tb.LutDims()
    luts = tb.AtmosphereLUTs(**{n: torch.zeros(s) for n, s in
                                d.shapes().items()})
    k4 = tr.pack_k4_luts(luts)
    assert tuple(k4.scattering_mie.shape) == (32, 128, 256, 8)
    assert all(getattr(k4, n).is_contiguous() for n in (
        "transmittance", "irradiance", "scattering_mie"))
    assert k4.nbytes == 32 * 128 * 256 * 8 * 4 + (64 * 256 + 16 * 64) * 16
    assert sum(t.numel() * 4 for t in (
        luts.transmittance, luts.scattering, luts.single_mie,
        luts.irradiance)) == 2 * 32 * 128 * 256 * 12 + (64 * 256
                                                         + 16 * 64) * 12
    assert [f.name for f in dataclasses.fields(luts)] == [
        "transmittance", "scattering", "single_mie", "irradiance"]


def test_sass_count_places_the_loads(tmp_path, capsys):
    """tools/sass_count.py counts the global loads by opcode and, for
    each, the loads in flight when what it loaded is first read."""
    import json

    from vpt_tpu_torch.tools import sass_count
    ops = ["LDG.E.128.CONSTANT R4, desc[UR4][R2.64]",
           "LDG.E.128.CONSTANT R8, desc[UR4][R2.64+0x10]",
           "FADD R12, R4, R8", "LDG.E R13, desc[UR4][R6.64]",
           "STG.E desc[UR4][R6.64], R13", "EXIT"]
    with open(tmp_path / "k.txt", "w") as f:
        f.write("\t\tFunction : _Z17atmosphere_kernelILi256ELi1EEv\n")
        for i, op in enumerate(ops):
            f.write(f"        /*{16 * i:04x}*/   {op} ;\n")
    sass_count.main([str(tmp_path / "k.txt")])
    rec = json.loads(capsys.readouterr().out)
    assert rec["loads"] == {"LDG.E.128.CONSTANT": 2, "LDG.E": 1}
    assert rec["ldg_in_flight"] == dict(mean=4 / 3, max=2)
