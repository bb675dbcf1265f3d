// K2's ray, shared by K2 (raygen.cu) and K1's in-kernel-ray route
// (fused_direct.cu): pixel index -> jittered thin-lens primary ray.
//
// Replaces: vpt_tpu/render/renderer.py::_pixel_jitter (white noise) and
// vpt_tpu/core/camera.py::Camera.get_rays; the plain PyTorch version is
// vpt_tpu_torch/render/renderer.py::primary_rays_plain.  The draws are
// computed from their counters (jitter element (y*W + x)*2 + c, lens
// element y*W + x), so a ray needs no memory but its parameters; the
// same source under the same flags gives both kernels the same bits.
#pragma once

#include "vpt_common.cuh"

namespace vpt {

// Mirror of vpt_tpu_torch/render/renderer.py::_RaygenParams.
struct RaygenParams {
    int H, W;
    unsigned k_jit[2], k_lens_r[2], k_lens_phi[2];
    float origin[3], llc[3], horizontal[3], vertical[3], u[3], v[3];
    float lens_radius;
};

__device__ __forceinline__ void primary_ray(const RaygenParams& p, int i,
                                            V3& o, V3& d) {
    const int y = i / p.W, x = i - y * p.W;
    const unsigned long long n = (unsigned long long)i;
    const Key kj{p.k_jit[0], p.k_jit[1]};
    const float j0 = uniform_at(kj, 2 * n);
    const float j1 = uniform_at(kj, 2 * n + 1);
    const float s = ((float)x + j0) / (float)p.W;
    const float t = ((float)y + j1) / (float)p.H;
    const float r = sqrtf(uniform_at(Key{p.k_lens_r[0], p.k_lens_r[1]}, n));
    const float phi =
        TWO_PI_F * uniform_at(Key{p.k_lens_phi[0], p.k_lens_phi[1]}, n);
    const float rd = p.lens_radius * r;
    const V3 offset = v3(p.u) * (rd * cosf(phi)) + v3(p.v) * (rd * sinf(phi));
    o = v3(p.origin) + offset;
    d = normalize(v3(p.llc) + v3(p.horizontal) * s + v3(p.vertical) * t - o);
}

}  // namespace vpt
