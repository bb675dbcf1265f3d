// P3 — roll of an (N, C) float32 tensor along one axis by a shift s in
// [0, len): out[n, (c + s) mod C] = x[n, c] (axis 1), or
// out[(n + s) mod N, c] = x[n, c] (axis 0).
//
// Replaces the Pallas probe kernel of tools/probe_axis0.py:59
// (kern_roll: pltpu.roll(x, shift=3, axis=1), which equals
// np.roll(x, 3, 1)).  Its plain PyTorch version is
// vpt_tpu_torch/ops/probe.py::roll_plain; the launch is computed by
// probe.py::roll_launch.
//
// What bounds it on the H100: bytes (one read and one write per
// element); at the probe's (8, 128) it is the launch alone, one block.
//
// What the design does about it: each thread writes 4 consecutive
// elements of out, as one 16-byte store when C % 4 == 0, and reads
// their sources: (n, c) from a per-launch divider, 32-bit offsets, the
// source column or row brought back into range with one unsigned
// min(s, s - len), no division per element.  A whole row moves on axis
// 0, and on axis 1 with s % 4 == 0 no 4-vector straddles the wrap
// point, so those read 16 bytes too; otherwise the 4 reads are scalar,
// neighbouring lanes on neighbouring addresses.

#include <cuda_runtime.h>

#include "probe_launch.cuh"

namespace {

template <bool VEC>
__global__ void __launch_bounds__(256)
roll_kernel(const float* __restrict__ x, float* __restrict__ out,
            const ProbeLaunch p) {
    const unsigned N = (unsigned)p.N, C = (unsigned)p.C, total = N * C;
    const unsigned e0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4u;
    if (e0 >= total) return;
    unsigned n = udiv(e0, p.c_magic, p.c_shift), c = e0 - n * C;
    const unsigned s = (unsigned)p.shift;
    if (VEC) {
        float4 v;
        if (p.axis == 0) {
            unsigned r = n + N - s;
            r = min(r, r - N);
            v = __ldg(reinterpret_cast<const float4*>(x + r * C + c));
        } else if (s % 4u == 0) {
            unsigned sc = c + C - s;
            sc = min(sc, sc - C);
            v = __ldg(reinterpret_cast<const float4*>(x + n * C + sc));
        } else {
            float f[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                unsigned sc = c + k + C - s;
                sc = min(sc, sc - C);
                f[k] = __ldg(x + n * C + sc);
            }
            v = make_float4(f[0], f[1], f[2], f[3]);
        }
        *reinterpret_cast<float4*>(out + e0) = v;
        return;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (e0 + k >= total) return;
        unsigned src;
        if (p.axis == 0) {
            unsigned r = n + N - s;
            r = min(r, r - N);
            src = r * C + c;
        } else {
            unsigned sc = c + C - s;
            sc = min(sc, sc - C);
            src = n * C + sc;
        }
        out[e0 + k] = __ldg(x + src);
        if (++c == C) { c = 0; ++n; }
    }
}

}  // namespace

extern "C" int vpt_roll(const float* x, float* out, const ProbeLaunch* pp,
                        void* stream) {
    const ProbeLaunch p = *pp;
    const dim3 grid(p.grid_x, p.grid_y), block(p.threads);
    if (p.vec)
        roll_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
            x, out, p);
    else
        roll_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
            x, out, p);
    return (int)cudaGetLastError();
}
