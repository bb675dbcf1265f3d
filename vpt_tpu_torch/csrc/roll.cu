// P3 — roll of an (N, C) float32 tensor along one axis by a shift s in
// [0, len): out[n, (c + s) mod C] = x[n, c] (axis 1), or
// out[(n + s) mod N, c] = x[n, c] (axis 0); one thread per element.
//
// Replaces the Pallas probe kernel of tools/probe_axis0.py:59
// (kern_roll: pltpu.roll(x, shift=3, axis=1), which equals
// np.roll(x, 3, 1)).  Its plain PyTorch version is
// vpt_tpu_torch/ops/probe.py::roll_plain.
//
// What bounds it on the H100: bytes (one read and one write per
// element); at the probe's (8, 128) it is the launch alone.
//
// What the design does about it: neighbouring threads read neighbouring
// elements, and the stores, shifted by s, stay contiguous except at the
// one wrap-around point of each row.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
roll_kernel(const float* __restrict__ x, float* __restrict__ out, int N,
            int C, int axis, int shift) {
    const long long total = (long long)N * C;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < total; e += stride) {
        const long long n = e / C, c = e - n * C;
        const long long dst = axis == 1 ? n * C + (c + shift) % C
                                        : ((n + shift) % N) * C + c;
        out[dst] = x[e];
    }
}

}  // namespace

extern "C" int vpt_roll(const float* x, float* out, int N, int C, int axis,
                        int shift, void* stream) {
    const long long total = (long long)N * C;
    if (total <= 0) return 0;
    const int threads = 256;
    const long long want = (total + threads - 1) / threads;
    const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
    roll_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        x, out, N, C, axis, shift);
    return (int)cudaGetLastError();
}
