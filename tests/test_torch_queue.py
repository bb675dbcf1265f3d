"""The step budget at the sizes where the reference queues rays (render/
params.py::resolve_queue), and the layout of K1's outputs that K4 reads,
on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from vpt_tpu.render.params import Integrator as JIntegrator
from vpt_tpu.render.params import RenderParams as JParams
from vpt_tpu.render.renderer import _resolve_auto_queue
from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.camera import Camera
from vpt_tpu_torch.lights.lights import PointLights
from vpt_tpu_torch.render import film as tfilm
from vpt_tpu_torch.render import fused
from vpt_tpu_torch.render.params import (AUTO_QUEUE, Environment,
                                         RenderParams, resolve_queue)
from vpt_tpu_torch.render.renderer import frame_queue, primary_rays
from vpt_tpu_torch.scene.scene import attach_env_map, build_scene
from vpt_tpu_torch.volume.grid import HostGrid


@pytest.mark.parametrize("n", [131071, 131072, 262144, 4096])
@pytest.mark.parametrize("variant", [
    {}, {"engine": "march"}, {"engine": "reference"},
    {"integrator": int(JIntegrator.VOLUMETRIC)}, {"rays_per_lane": 1}])
def test_resolve_queue_matches_reference(n, variant):
    want = _resolve_auto_queue(JParams(**variant), n).rays_per_lane
    assert resolve_queue(RenderParams(**variant), n) == want


def test_resolve_queue_refuses_explicit_queues():
    with pytest.raises(NotImplementedError):
        resolve_queue(RenderParams(rays_per_lane=4), 16)


def test_frame_queue_is_the_frame_size_rule():
    assert frame_queue(RenderParams(width=512, height=256)) == AUTO_QUEUE
    assert frame_queue(RenderParams(width=511, height=256)) == 1
    assert frame_queue(RenderParams()) == AUTO_QUEUE     # the CLI's 512^2


def _scene(n=16):
    z, y, x = np.mgrid[:n, :n, :n].astype(np.float32)
    r = np.sqrt((x - n / 2) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)
    dens = np.clip(1.5 - r / (n / 2.4), 0.0, 1.0).astype(np.float32)
    g = HostGrid(density_zyx=dens, emission_zyx=None, color_zyx=None,
                 bbox_min=np.zeros(3, np.int32),
                 dim=np.array([n, n, n], np.int32),
                 transform=np.diag([0.2, 0.2, 0.2, 1.0]), voxel_size=0.2,
                 max_density=float(dens.max()), min_density=1e-6)
    s = build_scene([g], lights=PointLights.make(
        [[2.0, 3.0, 4.0]], [[1, 1, 1]], [30.0], device="cpu"), device="cpu")
    lo, hi = s.root_pmin.numpy(), s.root_pmax.numpy()
    c, d = (lo + hi) / 2, float(np.linalg.norm(hi - lo)) * 1.2
    return dataclasses.replace(s, camera=Camera.make(
        c + np.array([0.0, 0.15 * d, d]), c, vfov=30.0, device="cpu"))


@pytest.mark.parametrize("env", ["atmosphere", "constant"])
def test_queued_cut_rays_are_unretired_slots(env):
    """At Q = 16 with a budget that cuts: a cut ray is written as the
    reference's unretired queue slot (L, alpha, cost, depth 0,
    unfinished 1), and a ray that finishes is bit for bit a Q = 1 run
    whose budget is 16 times as large."""
    s = _scene()
    et = dict(atmosphere=Environment.ATMOSPHERE,
              constant=Environment.CONSTANT)[env]
    kw = dict(width=32, height=32, ray_depth=8, shadow_mode="tracked",
              environment_type=int(et), sky_mult=0.5, density_mult=16.0)
    p16 = RenderParams(max_fused_steps=1, **kw)
    p1 = RenderParams(max_fused_steps=AUTO_QUEUE, **kw)
    key = rng.render_key(0, 0)
    o, d = primary_rays(s.camera, p16, key)
    tkey = rng.fold_in(key, 1000)
    q = fused.fused_direct(s, p16, tkey, o, d, queue=AUTO_QUEUE)
    one = fused.fused_direct(s, p1, tkey, o, d, queue=1)
    cut = q[3] == 1.0
    assert 0 < int(cut.sum()) < cut.numel()
    assert torch.equal(cut, one[3] == 1.0)
    assert float(q[0][~cut].sum()) > 0
    for a, b in zip(q, one):
        assert torch.equal(a[~cut], b[~cut])
    for x in (q[0], q[1], q[2], q[4]):
        assert torch.equal(x[cut], torch.zeros_like(x[cut]))
    # Q = 1 at the small budget keeps a cut ray's partial walk instead
    small = fused.fused_direct(s, p16, tkey, o, d, queue=1)
    assert float(small[2][small[3] == 1.0].min()) > 0


@pytest.mark.parametrize("B", [1, 3, 6, 1073])
@pytest.mark.parametrize("defer", [0, 1])
def test_k1_output_views_with_deferred_env(B, defer):
    """With a deferred environment K1's buffer also holds beta and the
    direction, K4's inputs, each starting 16-byte aligned after the five
    outputs; the budget is max_fused_steps times the queue."""
    p = fused._FusedParams()
    p.key_steps, p.defer_env = 128, defer
    launch = fused.FusedLaunch(p, torch.zeros(1), None, None, None)
    q, out, views = fused._launch_args(launch, B, (0, 0), None, 16)
    assert (q.max_steps, q.queued) == (128 * 16, 1)
    assert [tuple(v.shape) for v in views] == (
        [(B, 3)] + [(B,)] * 4 + [(B, 3)] * 2 * defer)
    starts = [v.data_ptr() - out.data_ptr() for v in views]
    assert all(v.data_ptr() % 16 == 0 for v in views), starts
    spans = sorted((a, a + v.numel() * 4) for a, v in zip(starts, views))
    assert all(e <= b for (_, e), (b, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= out.numel() * 4


@pytest.mark.parametrize("offsets,want", [
    ((0, 16, 4096), "float4"), ((0, 4, 32), "scalar"),
    ((8, 16), "scalar"), ((12,), "scalar"), ((), "float4")])
def test_accumulate_design(offsets, want):
    """K3 moves 16 bytes at a time only where every tensor starts on a
    16-byte boundary; a view offset by 1-3 floats takes the scalar
    route."""
    assert tfilm.accumulate_design(0x7f0000000000 + o for o in offsets) \
        == want


def test_attach_env_map_checks_shape():
    s = _scene(8)
    with pytest.raises(ValueError):
        attach_env_map(s, np.zeros((4, 8), np.float32))
    m = np.ones((4, 8, 3), np.float32)
    assert attach_env_map(s, m).env_map.shape == (4, 8, 3)
