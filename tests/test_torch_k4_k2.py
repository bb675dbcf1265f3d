"""K4's division by the sky's constants and K2's lens skip, on the CPU.

K4 divides by HR and HM with RN(1/d) as div_known2
(vpt_tpu_torch/csrc/vpt_common.cuh): Markstein's division with an FMA,
IEEE division below 2^-100.  Here it is emulated exactly in rationals
and held to float32 division (numpy's, correctly rounded), as is the
port's numpy emulation (sky/procedural.py::div_known_plain), which the
CPU route of integrator.div_known_sweep uses.  K2 skips its lens draws
where renderer.lens_draws_needed says they cannot change a bit; the
identity that rests on is checked on primary_rays_plain.  The card's
own checks are in tests/test_torch_cuda.py (marker ``cuda``).

    python -m pytest tests/test_torch_k4_k2.py -q
"""

import ctypes
from fractions import Fraction

import numpy as np
import pytest
import torch

from test_torch_cuda import _c_fields  # tests/, on sys.path under pytest
from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.camera import Camera
from vpt_tpu_torch.render import integrator, renderer
from vpt_tpu_torch.render.params import RenderParams
from vpt_tpu_torch.sky import procedural

FLT_MAX = float(np.finfo(np.float32).max)
DIVISORS = {"hr": procedural.HR, "hm": procedural.HM}


def _rn32(q: Fraction) -> float:
    """q rounded to the nearest float32, ties to even, in exact integer
    arithmetic (normal and subnormal results; finite q)."""
    if q == 0:
        return 0.0
    sign, a = (-1 if q < 0 else 1), abs(q)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    e = max(e, -126)                      # the subnormals' fixed step
    scaled = a / Fraction(2) ** (e - 23)  # the significand, in ulps
    n, rem = divmod(scaled.numerator, scaled.denominator)
    twice = 2 * rem
    if twice > scaled.denominator or (twice == scaled.denominator
                                      and n % 2 == 1):
        n += 1
    return sign * float(Fraction(n) * Fraction(2) ** (e - 23))


def _div_known_exact(x: float, d: float, y: float) -> float:
    """csrc/vpt_common.cuh::div_known2's quotient by d for a finite x,
    each operation rounded once from its exact value."""
    if not abs(x) >= procedural.DIV_KNOWN_MIN:
        return _rn32(Fraction(x) / Fraction(d))
    q0 = _rn32(Fraction(x) * Fraction(y))
    r = min(_rn32(Fraction(x) - Fraction(q0) * Fraction(d)), FLT_MAX)
    return _rn32(Fraction(r) * Fraction(y) + Fraction(q0))


def _test_values(n=10_000, seed=0):
    """Heights from -1e4 to 1e5 m in 0.5 m steps, n of them sampled, and
    n random finite float32 bit patterns."""
    g = np.random.default_rng(seed)
    heights = (g.choice(220_001, n, replace=False) * 0.5 - 1e4).astype(
        np.float32)
    bits = g.integers(0, 2 ** 32, 3 * n, dtype=np.uint64).astype(np.uint32)
    finite = bits[(bits >> 23) & 0xFF != 0xFF][:n]
    return np.concatenate([heights, -heights, finite.view(np.float32)])


def test_sky_constants_give_rounded_reciprocals():
    """(i) hr_inv and hm_inv are RN32(1/d): the float32 nearest to the
    exact reciprocal of the float32 divisor."""
    c = procedural.sky_constants()
    for name, d in DIVISORS.items():
        y = c[f"{name}_inv"]
        assert y == float(np.float32(1.0) / np.float32(d))
        assert y == _rn32(1 / Fraction(float(np.float32(d))))
        assert c[name] == float(np.float32(d))


@pytest.mark.parametrize("name", list(DIVISORS))
def test_div_known_exact_emulation_is_ieee_division(name):
    """(ii) div_known2, emulated in rationals, equals float32 division by
    HR and HM bit for bit on ~30,000 values: heights in 0.5 m steps (both
    signs) and random finite bit patterns."""
    d = np.float32(DIVISORS[name])
    y = procedural.sky_constants()[f"{name}_inv"]
    x = _test_values()
    want = x / d
    got = np.array([_div_known_exact(float(v), float(d), y) for v in x],
                   np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", list(DIVISORS))
def test_div_known_plain_matches_exact_emulation(name):
    """The numpy emulation (div_known_plain) equals the rational one and
    float32 division on the same values, and keeps NaN, +-Inf and the
    sign of zero."""
    d = np.float32(DIVISORS[name])
    y = procedural.sky_constants()[f"{name}_inv"]
    x = _test_values(seed=1)
    exact = np.array([_div_known_exact(float(v), float(d), y) for v in x],
                     np.float32)
    got = procedural.div_known_plain(x, d, y)
    assert np.array_equal(got.view(np.uint32), exact.view(np.uint32))
    special = np.array([np.inf, -np.inf, 0.0, -0.0, np.nan], np.float32)
    sp = procedural.div_known_plain(special, d, y)
    assert np.array_equal(sp[:4].view(np.uint32),
                          (special[:4] / d).view(np.uint32))
    assert np.isnan(sp[4])


@pytest.mark.parametrize("name", list(DIVISORS))
@pytest.mark.parametrize("lo", [
    0x3F800000,                  # [1, 2)
    0x0D800000 - 2 ** 19,        # across 2^-100, where the paths meet
    0x00000000,                  # +0 and the smallest subnormals
    0x80000000,                  # -0 and the negative subnormals
    0x7F800000 - 2 ** 19,        # the largest floats, +Inf and NaNs
    0xFF800000 - 2 ** 19])       # the same, negative
def test_div_known_sweep_on_the_cpu(name, lo):
    """integrator.div_known_sweep's CPU route finds no mismatch in 2^20
    patterns at each edge of div_known2's paths."""
    c = procedural.sky_constants()
    assert integrator.div_known_sweep(c[name], c[f"{name}_inv"], lo,
                                      lo + 2 ** 20, "cpu") == (0, None)


def test_div_known_sweep_finds_a_wrong_reciprocal():
    """The sweep is not blind: with y 0.1% off RN(1/HR) (the remainder is
    then no longer exact) it counts mismatches and names the first."""
    c = procedural.sky_constants()
    y = float(np.float32(c["hr_inv"] * 1.001))
    bad, first = integrator.div_known_sweep(c["hr"], y, 0x3F800000,
                                            0x3F800000 + 2 ** 18, "cpu")
    assert bad > 0 and 0x3F800000 <= first < 0x3F800000 + 2 ** 18


def test_div_known_sweep_refuses_a_range_past_2_32():
    with pytest.raises(ValueError):
        integrator.div_known_sweep(7994.0, 1 / 7994.0, 0, 2 ** 32 + 1, "cpu")


def _camera(aperture=0.0, origin=(1.5, 20.0, 60.0)):
    return Camera.make(origin, (0.0, 0.0, 0.0), vfov=40.0, aspect=1.25,
                       aperture=aperture, device="cpu")


def test_lens_draws_needed():
    """(iii) False at aperture 0, True at aperture > 0, True with a -0.0
    origin component, and True where the lens frame or the origin is not
    finite (an offset or sum that is not +-0 or not the origin)."""
    import dataclasses
    assert renderer.lens_draws_needed(_camera(0.0)) is False
    assert renderer.lens_draws_needed(_camera(0.0, (0.0, 20.0, 60.0))) \
        is False
    assert renderer.lens_draws_needed(_camera(0.5)) is True
    assert renderer.lens_draws_needed(_camera(1e-30)) is True
    assert renderer.lens_draws_needed(_camera(0.0, (-0.0, 20.0, 60.0))) \
        is True
    cam = _camera(0.0)
    u = cam.u.clone()
    u[1] = float("nan")
    assert renderer.lens_draws_needed(dataclasses.replace(cam, u=u)) is True
    o = cam.origin.clone()
    o[2] = float("inf")
    assert renderer.lens_draws_needed(dataclasses.replace(cam, origin=o)) \
        is True
    neg = dataclasses.replace(cam, lens_radius=torch.tensor(-0.0))
    assert renderer.lens_draws_needed(neg) is False


@pytest.mark.parametrize("origin", [(1.5, 20.0, 60.0), (0.0, -3.25, 7.0),
                                    (-2.0, 0.0, 0.0)])
def test_primary_rays_plain_keeps_the_origin_at_aperture_0(origin):
    """(iv) primary_rays_plain draws the lens at aperture 0 too, and the
    origins it returns are camera.origin bit for bit for a camera with no
    -0.0 component: the identity K2's skip rests on.  With a -0.0
    component some origins come back +0.0, so the draws are needed."""
    p = RenderParams(width=23, height=17)
    key = rng.render_key(3, 5)
    cam = _camera(0.0, origin)
    o, d = renderer.primary_rays_plain(cam, p, key)
    want = cam.origin.expand_as(o)
    assert torch.equal(o.view(torch.int32), want.view(torch.int32))
    assert torch.isfinite(d).all()
    neg = _camera(0.0, (-0.0, 2.0, 9.0))
    o2, _ = renderer.primary_rays_plain(neg, p, key)
    signs = torch.signbit(o2[:, 0])
    assert not signs.all()


@pytest.mark.parametrize("source,struct,mirror,new", [
    ("environment.cu", "EnvParams", integrator._EnvParams,
     ["hm", "hr_inv", "hm_inv", "c_r"]),
    ("raygen.cuh", "RaygenParams", renderer._RaygenParams, [])])
def test_new_struct_fields_in_c_order(source, struct, mirror, new):
    """(v) the ctypes mirrors match the C structs field for field: EnvParams
    carries the new reciprocals after hm, with the C types' sizes;
    RaygenParams gains no field (K2 takes its lens choice as a launch
    argument)."""
    mine = [f[0] for f in mirror._fields_]
    assert mine == _c_fields(source, struct)
    assert "lens_draws" not in mine
    if new:
        at = mine.index(new[0])
        assert mine[at:at + len(new)] == new
    kinds = dict(mirror._fields_)
    for name in new[1:]:
        assert kinds[name] is ctypes.c_float, name


def test_prepare_raygen_fills_lens_draws(monkeypatch):
    """prepare_raygen hands K2's launch lens_draws_needed's answer.  The
    struct is built here without a card: the camera's origin reports a
    CUDA device and the library's size check is skipped."""
    import dataclasses
    import types
    from vpt_tpu_torch.ops import cuda
    monkeypatch.setattr(cuda, "check_struct", lambda *a: None)
    monkeypatch.setattr(cuda, "load_library", lambda: types.SimpleNamespace(
        dll=types.SimpleNamespace(vpt_raygen_params_size=None)))
    p = RenderParams(width=8, height=4)
    for aperture, origin, want in ((0.0, (1.5, 20.0, 60.0), False),
                                   (0.5, (1.5, 20.0, 60.0), True),
                                   (0.0, (-0.0, 20.0, 60.0), True)):
        cam = _camera(aperture, origin)
        o = cam.origin
        fake = dataclasses.replace(cam, origin=types.SimpleNamespace(
            device=torch.device("cuda", 0), cpu=o.cpu, tolist=o.tolist))
        got = renderer.prepare_raygen(fake, p)
        assert got.lens_draws is want
        assert got.lens_radius == aperture / 2
        assert list(got.origin) == o.tolist()
