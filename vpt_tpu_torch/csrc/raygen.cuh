// K2's ray, shared by K2 (raygen.cu) and K1's in-kernel-ray route
// (fused_direct.cu): pixel index -> jittered thin-lens primary ray.
//
// Replaces: vpt_tpu/render/renderer.py::_pixel_jitter (white noise) and
// vpt_tpu/core/camera.py::Camera.get_rays; the plain PyTorch version is
// vpt_tpu_torch/render/renderer.py::primary_rays_plain.  The draws are
// computed from their counters (jitter element (y*W + x)*2 + c, lens
// element y*W + x; each below 2^32, so the counter's high word is 0), so
// a ray needs no memory but its parameters; the same source under the
// same flags gives both kernels the same bits.
//
// The lens draws (two threefry draws, a sqrtf, a cosf and a sinf) are
// skipped where they cannot change a bit: with lens_radius = +-0 every
// offset component is +-0, and origin + (+-0) is origin for a finite
// origin component that is not -0.0 (render/renderer.py::
// lens_draws_needed decides on the host, and K2's launcher takes its
// answer as an argument).  K2 skips them there; K1's in-kernel-ray route
// takes them always (fused_direct.cu says why).
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

// The ray of pixel i (< 2^31); `lens` says whether to take the lens
// draws: K2 specialises on its launcher's lens_draws, K1 takes them
// always.
__device__ __forceinline__ void primary_ray(const RaygenParams& p, int i,
                                            bool lens, V3& o, V3& d) {
    const int y = i / p.W, x = i - y * p.W;
    const uint32_t n = (uint32_t)i;
    const Key kj{p.k_jit[0], p.k_jit[1]};
    const float j0 = uniform_at32(kj, 2u * n);
    const float j1 = uniform_at32(kj, 2u * n + 1u);
    const float s = ((float)x + j0) / (float)p.W;
    const float t = ((float)y + j1) / (float)p.H;
    o = v3(p.origin);
    if (lens) {
        const float r =
            sqrtf(uniform_at32(Key{p.k_lens_r[0], p.k_lens_r[1]}, n));
        const float phi =
            TWO_PI_F * uniform_at32(Key{p.k_lens_phi[0], p.k_lens_phi[1]}, n);
        const float rd = p.lens_radius * r;
        const V3 offset =
            v3(p.u) * (rd * cosf(phi)) + v3(p.v) * (rd * sinf(phi));
        o = o + offset;
    }
    d = normalize(v3(p.llc) + v3(p.horizontal) * s + v3(p.vertical) * t - o);
}

}  // namespace vpt
