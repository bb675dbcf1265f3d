// K2 — primary ray generation, one thread per pixel, into two buffers.
//
// Replaces: vpt_tpu/render/renderer.py::_pixel_jitter (white noise) and
// vpt_tpu/core/camera.py::Camera.get_rays.  Its plain PyTorch version
// is vpt_tpu_torch/render/renderer.py::primary_rays_plain.
//
// What bounds it on the H100: bytes written — 24 bytes of origin and
// direction per pixel; the four threefry draws per pixel (two jitter,
// two lens) are a few hundred integer operations and stay below the
// store time at 1080p.
//
// What the design does about it: the ray itself (raygen.cuh) reads
// nothing but its parameters.  With cached shadows the renderer does
// not launch this kernel: K1's in-kernel-ray route (fused_direct.cu)
// calls the same primary_ray in each lane and moves no ray buffer.  With
// tracked shadows, and in the parity checks, this kernel feeds K1's
// buffer route.

#include "raygen.cuh"

using namespace vpt;

namespace {

__global__ void __launch_bounds__(256)
primary_rays_kernel(const RaygenParams p, float* __restrict__ origin,
                    float* __restrict__ direction) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)p.H * p.W) return;
    V3 o, d;
    primary_ray(p, (int)i, o, d);
    origin[3 * i + 0] = o.x;
    origin[3 * i + 1] = o.y;
    origin[3 * i + 2] = o.z;
    direction[3 * i + 0] = d.x;
    direction[3 * i + 1] = d.y;
    direction[3 * i + 2] = d.z;
}

}  // namespace

extern "C" int vpt_raygen_params_size() { return (int)sizeof(RaygenParams); }

extern "C" int vpt_primary_rays(const void* params, float* origin,
                                float* direction, void* stream) {
    const RaygenParams& p = *static_cast<const RaygenParams*>(params);
    const long long n = (long long)p.H * p.W;
    if (n <= 0) return 0;
    const int threads = 256;
    const int blocks = (int)((n + threads - 1) / threads);
    primary_rays_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        p, origin, direction);
    return (int)cudaGetLastError();
}
