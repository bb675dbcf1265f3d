// P2 — take_along_axis along axis 0 or 1 of an (N, C) float32 tensor,
// repeated ``iters`` times with an accumulate-and-reindex update, one
// thread per element:
//
//     acc = 0; j = idx[n, c]
//     for i in range(iters):
//         acc += x[j, c] (axis 0) or x[n, j] (axis 1)
//         j = (j + int32(acc) + i) mod len(axis)      (floor mod)
//     out[n, c] = acc
//
// Replaces the Pallas probe kernels of tools/probe_axis0.py:42
// (make -> kern: one take_along_axis, here iters = 1, since 0 + r == r)
// and tools/probe_dyngather.py:73 (make_pallas -> kern: 64 steps of the
// loop above).  Its plain PyTorch version is
// vpt_tpu_torch/ops/probe.py::take_along_plain.
//
// What bounds it on the H100: at iters = 1, bytes (read x, idx, write
// out); at iters = 64, the chain of dependent loads of each element (the
// next index needs this step's sum) and its few integer operations per
// step — x of the probes' shapes (at most 2 MB) stays in L2 and L1.
//
// What the design does about it: each element's chain is independent of
// every other, so one thread walks it in registers and many threads hide
// each other's load latency; the float-to-int cast truncates toward zero
// and the adds run in order, as in the reference, so the result is exact.
// An index outside [0, len) reads NaN instead of memory outside x.
// Staging a column of x in shared memory is later work.

#include <cuda_runtime.h>

namespace {

template <typename I>
__global__ void __launch_bounds__(256)
take_along_kernel(const float* __restrict__ x, const I* __restrict__ idx,
                  float* __restrict__ out, int N, int C, int axis,
                  int iters) {
    const long long total = (long long)N * C;
    const long long len = axis == 0 ? N : C;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < total; e += stride) {
        const long long n = e / C, c = e - n * C;
        long long j = (long long)idx[e];
        float acc = 0.0f;
        for (int i = 0; i < iters; ++i) {
            const bool ok = j >= 0 && j < len;
            const float r = !ok ? __int_as_float(0x7fc00000)
                            : axis == 0 ? x[j * C + c]
                                        : x[n * C + j];
            acc = acc + r;
            long long m = (j + (long long)(int)acc + i) % len;
            j = m < 0 ? m + len : m;
        }
        out[e] = acc;
    }
}

template <typename I>
int launch(const float* x, const I* idx, float* out, int N, int C,
           int axis, int iters, void* stream) {
    const long long total = (long long)N * C;
    if (total <= 0) return 0;
    const int threads = 256;
    const long long want = (total + threads - 1) / threads;
    const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
    take_along_kernel<I><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        x, idx, out, N, C, axis, iters);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vpt_take_along_i32(const float* x, const int* idx,
                                  float* out, int N, int C, int axis,
                                  int iters, void* stream) {
    return launch<int>(x, idx, out, N, C, axis, iters, stream);
}

extern "C" int vpt_take_along_u32(const float* x, const unsigned* idx,
                                  float* out, int N, int C, int axis,
                                  int iters, void* stream) {
    return launch<unsigned>(x, idx, out, N, C, axis, iters, stream);
}
