"""The kernel wrappers: plain versions on CPU tensors, the kernel paths
refuse CPU tensors, and the package never imports jax.  The kernels
themselves are held against their plain versions on the card by
tests/test_torch_cuda.py."""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden_scenes import _blob
from vpt_tpu.render import film as jfilm
from vpt_tpu_torch.accel.shadow import attach_shadow_cache
from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.camera import Camera
from vpt_tpu_torch.lights.lights import PointLights
from vpt_tpu_torch.render import film as tfilm
from vpt_tpu_torch.render import fused, renderer
from vpt_tpu_torch.render.params import RenderParams
from vpt_tpu_torch.scene.scene import build_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = (fused.FUSED_DIRECT, renderer.RAYGEN, tfilm.FILM_ACCUMULATE)


def _scene(device="cpu"):
    g = _blob(16)
    s = build_scene([g], lights=PointLights.make([[2.0, 3.0, 4.0]],
                                                 [[1, 1, 1]], [30.0],
                                                 device=device),
                    device=device)
    c = ((s.root_pmin + s.root_pmax) / 2).cpu().numpy()
    d = float(np.linalg.norm((s.root_pmax - s.root_pmin).cpu().numpy())) * 1.2
    s = dataclasses.replace(s, camera=Camera.make(
        c + np.array([0.0, 0.15 * d, d]), c, vfov=40.0, device=device))
    return attach_shadow_cache(s, 150.0, 30.0)


def _film_inputs(device, seed=0, hw=(24, 20)):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g).to(device)
    film = tfilm.Film(rand(*hw, 3), rand(*hw), rand(*hw), rand(*hw),
                      rand(*hw))
    val = rand(*hw, 3) * 4.0
    val[::5, ::3, 1] = float("nan")
    val[::7, ::2, 0] = float("inf")
    alpha = rand(*hw)
    alpha[::3, ::4] = float("nan")
    return film, val, alpha, rand(*hw), rand(*hw), rand(*hw)


def test_cpu_wrappers_run_plain_versions():
    s = _scene()
    p = RenderParams(width=12, height=10, shadow_mode="cached",
                     environment_type=2, ray_depth=4)
    before = [k.launches for k in KERNELS]
    key = rng.render_key(0, 2)
    o, d = renderer.primary_rays(s.camera, p, key)
    o2, d2 = renderer.primary_rays_plain(s.camera, p, key)
    assert torch.equal(o, o2) and torch.equal(d, d2)
    out = fused.fused_direct(s, p, key, o, d)
    ref = fused.fused_direct_plain(s, p, key, o, d)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    film, val, alpha, dep, cost, tr = _film_inputs("cpu")
    f1 = tfilm.accumulate(film, val, alpha, 3, dep, cost, tr)
    f2 = tfilm.accumulate_plain(film, val, alpha, 3, dep, cost, tr)
    for name in ("accum", "alpha", "depth", "cost", "trunc"):
        assert torch.equal(getattr(f1, name), getattr(f2, name))
    assert [k.launches for k in KERNELS] == before


def test_accumulate_plain_matches_jax():
    film, val, alpha, dep, cost, tr = _film_inputs("cpu", seed=1)
    jf = jfilm.Film(*(jnp.asarray(getattr(film, n).numpy())
                      for n in ("accum", "alpha", "depth", "cost", "trunc")))
    want = jfilm.accumulate(jf, jnp.asarray(val.numpy()),
                            jnp.asarray(alpha.numpy()), jnp.uint32(3),
                            depth=jnp.asarray(dep.numpy()),
                            cost=jnp.asarray(cost.numpy()),
                            trunc=jnp.asarray(tr.numpy()))
    got = tfilm.accumulate_plain(film, val, alpha, 3, dep, cost, tr)
    for name in ("accum", "alpha", "depth", "cost", "trunc"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert np.isfinite(got.accum.numpy()).all()


@pytest.mark.parametrize("absent", [("depth",), ("cost",), ("trunc",),
                                    ("depth", "cost", "trunc")])
def test_accumulate_without_fields_matches_jax(absent):
    """depth, cost and trunc may each be None, as in the reference: the
    film's field is carried over, the rest accumulate."""
    film, val, alpha, dep, cost, tr = _film_inputs("cpu", seed=3)
    aux = {"depth": dep, "cost": cost, "trunc": tr}
    for name in absent:
        aux[name] = None
    jf = jfilm.Film(*(jnp.asarray(getattr(film, n).numpy())
                      for n in ("accum", "alpha", "depth", "cost", "trunc")))
    want = jfilm.accumulate(jf, jnp.asarray(val.numpy()),
                            jnp.asarray(alpha.numpy()), jnp.uint32(5),
                            **{k: None if v is None else jnp.asarray(
                                v.numpy()) for k, v in aux.items()})
    got = tfilm.accumulate(film, val, alpha, 5, **aux)
    for name in ("accum", "alpha", "depth", "cost", "trunc"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    for name in absent:
        assert getattr(got, name) is getattr(film, name)


@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 6, 7, 1073])
def test_k1_output_views_start_16_byte_aligned(B):
    """K1's outputs are views into one buffer; each starts on a 16-byte
    boundary whatever the ray count, as K3 requires, and none overlaps
    another."""
    launch = fused.FusedLaunch(fused._FusedParams(), torch.zeros(1), None,
                               None, None)
    p, out, views = fused._launch_args(launch, B, (0, 0), None)
    assert p.B == B
    assert [tuple(v.shape) for v in views] == [(B, 3)] + [(B,)] * 4
    starts = [v.data_ptr() - out.data_ptr() for v in views]
    assert all(v.data_ptr() % 16 == 0 for v in views), starts
    spans = sorted((a, a + v.numel() * 4) for a, v in zip(starts, views))
    assert all(e <= b for (_, e), (b, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= out.numel() * 4


def test_film_save_load_round_trip(tmp_path):
    film = _film_inputs("cpu", seed=2)[0]
    path = str(tmp_path / "film.npz")
    tfilm.save_film(path, film, 7)
    back, it = tfilm.load_film(path, device="cpu")
    assert it == 7
    for name in ("accum", "alpha", "depth", "cost", "trunc"):
        assert torch.equal(getattr(back, name), getattr(film, name))
    # the reference reads the port's checkpoint
    jf, jit = jfilm.load_film(path)
    assert jit == 7
    np.testing.assert_array_equal(np.asarray(jf.accum), film.accum.numpy())


def test_kernel_paths_reject_cpu_tensors():
    s = _scene()
    p = RenderParams(width=4, height=4, environment_type=2)
    o = torch.zeros((16, 3))
    with pytest.raises(ValueError):
        fused._fused_direct_cuda(s, p, (0, 1), o, o + 1.0)
    with pytest.raises(ValueError):
        renderer._primary_rays_cuda(s.camera, p, (0, 1))
    film, val, alpha, dep, cost, tr = _film_inputs("cpu")
    with pytest.raises(ValueError):
        tfilm._accumulate_cuda(film, val, alpha, 0, dep, cost, tr)
    with pytest.raises(ValueError):
        tfilm._accumulate_cuda(film, val, alpha, 0, None, None, None)


# One subprocess serves the two tests below: it imports every module of
# the port, renders on the CPU, and tries the entry points without a
# device; it prints one JSON line.
_SUBPROCESS = """
import importlib, json, pkgutil, sys
import vpt_tpu_torch
for m in pkgutil.walk_packages(vpt_tpu_torch.__path__, "vpt_tpu_torch."):
    importlib.import_module(m.name)
import torch
from vpt_tpu_torch.volume.procedural import create_procedural_grid
from vpt_tpu_torch.scene.scene import build_scene
from vpt_tpu_torch.lights.lights import PointLights
from vpt_tpu_torch.accel.shadow import attach_shadow_cache
from vpt_tpu_torch.render.params import RenderParams
from vpt_tpu_torch.render.renderer import ProgressiveRenderer
from vpt_tpu_torch.app import cli
out = {}
g = create_procedural_grid(vmin=(-6,)*3, vmax=(6,)*3, scale=0.1,
                           device='cpu')
s = build_scene([g], lights=PointLights.make([[0, 9, 9]], [[1, 1, 1]],
                                             [50.0], device='cpu'),
                device='cpu')
s = attach_shadow_cache(s, 150.0, 30.0)
r = ProgressiveRenderer(s, RenderParams(width=8, height=8,
    environment_type=2, shadow_mode='cached', ray_depth=3))
out['cpu_render'] = list(r.render(1).accum.shape)
out['cpu_scene'] = str(s.device)
out['cuda_available'] = torch.cuda.is_available()
def fails(fn):
    try:
        fn()
    except SystemExit as e:
        return 'exit %s' % (e.code,) if e.code else False
    except Exception as e:
        return type(e).__name__
    return False
out['build_scene'] = fails(lambda: build_scene([g]))
out['grid'] = fails(lambda: create_procedural_grid(vmin=(-2,)*3,
                                                   vmax=(2,)*3))
out['cli'] = fails(lambda: cli.main(['render', 'procedural', '--env-type',
                                     'black', '--spp', '1', '--width', '8',
                                     '--height', '8', '-o', 'x.png']))
out['imported'] = sorted(m for m in sys.modules if m == 'jax' or
    m.startswith(('jax.', 'jaxlib', 'vpt_tpu.')) or m == 'vpt_tpu')
out['modules'] = sorted(m for m in sys.modules
                        if m.startswith('vpt_tpu_torch.'))
print('RESULT', json.dumps(out))
"""


@pytest.fixture(scope="module")
def port_subprocess(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _SUBPROCESS],
                         cwd=str(tmp_path_factory.mktemp("port")), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    line = next(ln for ln in res.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def test_port_never_imports_jax(port_subprocess):
    """Every module of vpt_tpu_torch (app.cli, tools.*, utils.*,
    ops.probe included) and one CPU render leave jax and vpt_tpu out of
    sys.modules."""
    out = port_subprocess
    assert out["cpu_render"] == [8, 8, 3]
    assert out["imported"] == []
    for mod in ("app.cli", "tools.probe_gather", "tools.probe_axis0",
                "tools.probe_dyngather", "utils.exr", "utils.io",
                "utils.logger", "ops.probe", "core.device"):
        assert f"vpt_tpu_torch.{mod}" in out["modules"]


def test_entry_points_default_to_the_card(port_subprocess):
    """Without a device argument the entry points build on the card; on
    a machine without one they raise torch's CUDA error (no fallback to
    the CPU), and the CLI without --cpu fails; device='cpu' works."""
    out = port_subprocess
    assert out["cpu_scene"] == "cpu"
    if out["cuda_available"]:
        pytest.skip("this machine has a card: the defaults run there")
    assert out["build_scene"] and out["grid"] and out["cli"]
    assert not str(out["cli"]).startswith("exit 0")
