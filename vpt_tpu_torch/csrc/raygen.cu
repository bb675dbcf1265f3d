// K2 — primary ray generation, one thread per pixel, into two buffers.
//
// Replaces: vpt_tpu/render/renderer.py::_pixel_jitter (white noise) and
// vpt_tpu/core/camera.py::Camera.get_rays.  Its plain PyTorch version
// is vpt_tpu_torch/render/renderer.py::primary_rays_plain.
//
// What bounds it on the H100: operations, not the 24 bytes it stores a
// pixel (0.0149 ms at 1080p over 3.35 TB/s).  A threefry-2x32 draw is
// about 75 integer operations (20 rounds of add, rotate and xor, 6 key
// injections, the bits' xor, shift and or), and integer operations run
// on the INT32 pipe at half the float32 rate.  At aperture 0 a pixel
// takes the 2 jitter draws: 155 integer and 33 float operations in the
// source (the time of 343 float ones, 0.0106 ms at 1080p) and 308 SASS
// instructions, 192 of them integer (0.024 ms on the INT32 pipe alone at
// 1.98 GHz).  With the lens draws: 305 integer and 54 float operations
// (664: 0.0205 ms) and 699 instructions, 490 integer (PERF.md).
//
// What the design does about it:
// - the lens draws are skipped where they cannot change a bit (aperture
//   0, raygen.cuh), which halves the integer work at the CLI's default;
//   the kernel is specialised on that choice, so neither variant
//   branches on it;
// - the draw counters are 32-bit (uniform_at32): the high word is 0;
// - a block stages its 256 origins and directions in shared memory and
//   writes each buffer as contiguous 16-byte stores (3,072 bytes a
//   buffer a block) instead of three strided 4-byte stores a thread.
// With cached shadows the renderer does not launch this kernel: K1's
// in-kernel-ray route (fused_direct.cu) calls the same primary_ray in
// each lane, with the lens draws, and moves no ray buffer.  With tracked
// shadows, and in the parity checks, this kernel feeds K1's buffer
// route.

#include <cstdint>

#include "raygen.cuh"

using namespace vpt;

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 3 * THREADS / 4;   // float4s a buffer a full block

template <bool LENS>
__global__ void __launch_bounds__(THREADS)
primary_rays_kernel(const RaygenParams p, int n, float* __restrict__ origin,
                    float* __restrict__ direction) {
    __shared__ float4 s_o[VEC], s_d[VEC];
    float* so = reinterpret_cast<float*>(s_o);
    float* sd = reinterpret_cast<float*>(s_d);
    const int t = threadIdx.x;
    const int base = blockIdx.x * THREADS;
    V3 o, d;
    if (base + t < n) primary_ray(p, base + t, LENS, o, d);
    if (n - base < THREADS) {
        // the frame's last, partial block: each thread its own 3 floats
        if (base + t < n) {
            const long long at = 3LL * (base + t);
            origin[at + 0] = o.x;
            origin[at + 1] = o.y;
            origin[at + 2] = o.z;
            direction[at + 0] = d.x;
            direction[at + 1] = d.y;
            direction[at + 2] = d.z;
        }
        return;
    }
    so[3 * t + 0] = o.x;
    so[3 * t + 1] = o.y;
    so[3 * t + 2] = o.z;
    sd[3 * t + 0] = d.x;
    sd[3 * t + 1] = d.y;
    sd[3 * t + 2] = d.z;
    __syncthreads();
    // 2 VEC float4s over THREADS threads, 16-byte aligned (3 THREADS
    // floats a block): the origins, then the directions
    float4* go = reinterpret_cast<float4*>(origin + 3LL * base);
    float4* gd = reinterpret_cast<float4*>(direction + 3LL * base);
    if (t < VEC) go[t] = s_o[t];
    else gd[t - VEC] = s_d[t - VEC];
    if (t < 2 * VEC - THREADS) gd[THREADS - VEC + t] = s_d[THREADS - VEC + t];
}

}  // namespace

extern "C" int vpt_raygen_params_size() { return (int)sizeof(RaygenParams); }

// K2 on the H x W pixels of `params` into (H*W, 3) origin and direction
// buffers, each 16-byte aligned; lens_draws = 0 skips the lens draws
// (render/renderer.py::lens_draws_needed says where that keeps the bits).
extern "C" int vpt_primary_rays(const void* params, int lens_draws,
                                float* origin, float* direction,
                                void* stream) {
    const RaygenParams& p = *static_cast<const RaygenParams*>(params);
    const long long n = (long long)p.H * p.W;
    if (n <= 0) return 0;
    if (n > 0x7fffffffLL ||
        (((uintptr_t)origin | (uintptr_t)direction) & 15u) != 0)
        return (int)cudaErrorInvalidValue;
    const int blocks = (int)((n + THREADS - 1) / THREADS);
    const cudaStream_t st = (cudaStream_t)stream;
    if (lens_draws)
        primary_rays_kernel<true><<<blocks, THREADS, 0, st>>>(
            p, (int)n, origin, direction);
    else
        primary_rays_kernel<false><<<blocks, THREADS, 0, st>>>(
            p, (int)n, origin, direction);
    return (int)cudaGetLastError();
}
