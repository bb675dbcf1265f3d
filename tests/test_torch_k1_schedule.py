"""K1's persistent schedule, on the CPU: the warp-efficiency measure of
the launch-order schedule, the CPU route of render_rays (the plain
primary_rays and fused_direct, keyed as the reference keys its tile),
and the CUDA routes' refusal of CPU tensors.  The kernel itself
is held against its buffer route and its plain version on the card by
tests/test_torch_cuda.py."""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_kernels import _scene
from vpt_tpu_torch.core import rng
from vpt_tpu_torch.render import fused, renderer
from vpt_tpu_torch.render.params import RenderParams


@pytest.mark.parametrize("cost,warp,want", [
    # every ray takes as many steps as its warp's longest: no idle lane
    (np.full(64, 7.0), 32, 1.0),
    # one ray of 33 steps per warp, the other 31 of one: (33 + 31) / (32 * 33)
    (np.tile(np.r_[33.0, np.ones(31)], 3), 32, 64 / (32 * 33)),
    # a tail group of 2 rays still holds 32 lanes: (32*4 + 4 + 2) / (2*32*4)
    (np.r_[np.full(32, 4.0), 4.0, 2.0], 32, 134 / 256),
    # the block of 128: four warps of 1, 2, 3 and 4 steps
    (np.repeat([1.0, 2.0, 3.0, 4.0], 32), 128, 320 / 512),
    # no ray takes a step
    (np.zeros(40), 32, 1.0),
])
def test_warp_efficiency(cost, warp, want):
    got = fused.warp_efficiency(torch.tensor(cost, dtype=torch.float32),
                                warp)
    assert got == pytest.approx(want, rel=1e-12)


def test_render_rays_cpu_route_is_the_plain_pipeline():
    """On the CPU render_rays is primary_rays_plain, then
    fused_direct_plain at the reference's tile key, bit for bit; the tile
    key is jax's fold_in(split(key)[1], 1000)."""
    s = _scene()
    p = RenderParams(width=12, height=10, shadow_mode="tracked",
                     environment_type=2, ray_depth=4)
    key = rng.render_key(0, 3)
    jkey = jax.random.fold_in(jax.random.split(
        jax.random.wrap_key_data(np.asarray(key, np.uint32)))[1], 1000)
    assert renderer.tile_key(key) == tuple(
        int(v) for v in jax.random.key_data(jkey))
    before = [k.launches for k in (fused.FUSED_DIRECT,
                                   fused.FUSED_DIRECT_PRIMARY,
                                   renderer.RAYGEN)]
    value, alpha, aux = renderer.render_rays(s, p, key)
    o, d = renderer.primary_rays_plain(s.camera, p, key)
    L, a, cost, unf, depth = fused.fused_direct_plain(
        s, p, renderer.tile_key(key), o, d)
    for got, want in ((value, L.reshape(10, 12, 3)), (alpha, a),
                      (aux["cost"], cost), (aux["trunc"], unf),
                      (aux["depth"], depth)):
        assert torch.equal(got.reshape(want.shape), want)
    assert [k.launches for k in (fused.FUSED_DIRECT,
                                 fused.FUSED_DIRECT_PRIMARY,
                                 renderer.RAYGEN)] == before


def test_rays_in_kernel_route_rejects_cpu_tensors():
    """Both CUDA routes of render_rays raise on a CPU scene."""
    s = _scene()
    p = RenderParams(width=4, height=4, environment_type=2)
    with pytest.raises(ValueError):
        renderer._trace_primary_cuda(s, p, (0, 1))
    with pytest.raises(ValueError):
        renderer._trace_buffers_cuda(s, p, (0, 1))
    with pytest.raises(ValueError):
        fused._fused_direct_primary_cuda(s, p, (0, 1),
                                         renderer._RaygenParams())
