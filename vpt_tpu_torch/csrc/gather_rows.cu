// P1 — row gather, out[b, :] = table[idx[b], :], one thread per output
// element.
//
// Replaces the Pallas probe kernels of tools/probe_gather.py:127 and :135
// (k_take, k_index, k_take_along: the row gather from a (V, 10) table;
// k_onedim: its column-0 form, here the same kernel at width 1 on the
// column made contiguous by the wrapper).  Its plain PyTorch version is
// vpt_tpu_torch/ops/probe.py::gather_rows_plain.
//
// What bounds it on the H100: bytes — each output element is one 4-byte
// load at a data-dependent row plus one store; there is no arithmetic
// beyond the address.  A random row of a large table costs whole 32-byte
// sectors, so narrow rows read more than they use.
//
// What the design does about it: neighbouring threads take neighbouring
// columns of one row and then the next row, so the loads of a row and the
// stores of the output are coalesced; offsets are 64-bit (the corner
// table is 8 M rows x 31 floats).  An index outside [0, n_rows) yields a
// NaN row instead of a read outside the table.  Wider loads (float4 per
// thread) and staging indices in shared memory are later work.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
gather_rows_kernel(const float* __restrict__ table,
                   const int* __restrict__ idx, float* __restrict__ out,
                   long long n_rows, int width, long long total) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < total; e += stride) {
        const long long b = e / width;
        const int w = (int)(e - b * width);
        const long long r = idx[b];
        out[e] = (r >= 0 && r < n_rows) ? table[r * width + w]
                                         : __int_as_float(0x7fc00000);
    }
}

}  // namespace

extern "C" int vpt_gather_rows(const float* table, const int* idx,
                               float* out, long long n_rows, int width,
                               long long batch, void* stream) {
    const long long total = batch * width;
    if (total <= 0) return 0;
    const int threads = 256;
    const long long want = (total + threads - 1) / threads;
    const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
    gather_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        table, idx, out, n_rows, width, total);
    return (int)cudaGetLastError();
}
