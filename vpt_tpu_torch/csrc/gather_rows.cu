// P1 — row gather, out[b, :] = table[idx[b], :], for a float32 table of
// n_rows rows of `width` floats lying `row_stride` floats apart.
//
// Replaces the Pallas probe kernels of tools/probe_gather.py:127 and :135
// (k_take, k_index, k_take_along: the row gather from a (V, 10) table;
// k_onedim: its column-0 form, here the same kernel at width 1 with the
// column's row stride).  Its plain PyTorch version is
// vpt_tpu_torch/ops/probe.py::gather_rows_plain; the launch (GatherLaunch)
// is computed by probe.py::gather_rows_design.
//
// Out-of-range indices are read as the Pallas bodies read them: an index
// in [-n_rows, 0) counts from the end; beyond that, "fill" (jnp.take and
// jnp.take_along_axis, the default) reads a NaN row and "clip" (k_index's
// t[idx], clip = 1) clamps into [0, n_rows).  Nothing outside the table
// is read.
//
// What bounds it on the H100: bytes, and the sectors they come in.  The
// bound counts each distinct row's bytes once; a random row of 31 floats
// (124 B, 4-byte aligned) touches 4-5 whole 32-byte sectors, about 152 B,
// so the sector floor lies ~8% above the byte bound at the main path's
// corner table.  And bytes in flight: at ~1 us of loaded latency, 3.35
// TB/s needs some 3 MB of loads in flight across 132 SMs, where one
// 4-byte load a thread (2048 threads an SM) keeps about 1 MB.
//
// What the design does about it:
// - A block owns `rows` consecutive output rows.  Their indices are read
//   once, coalesced, resolved (wrap, then fill or clip) and staged in
//   shared memory; every load of a row then reads its staged index.
// - The block's rows are one contiguous run of output vectors of VEC
//   floats (float4 where width, row stride and the table's address allow,
//   float2 where they are even, else scalar).  Each thread takes every
//   blockDim-th vector and issues UNROLL independent table loads through
//   the read-only path before its first store; `rows` is sized so a
//   thread's vectors fit one such pass.  Neighbouring threads read
//   neighbouring columns of a row, and write neighbouring output vectors,
//   with a streaming hint (the output is not read again here).
// - 32-bit index math inside a block, the row of a vector from the
//   per-launch divider udiv (vectors per row); 64-bit only in the table
//   offset and the block's output base.

#include <cuda_runtime.h>

#include "probe_launch.cuh"

// Mirrored by vpt_tpu_torch/ops/probe.py::_GatherLaunch.
struct GatherLaunch {
    int n_rows, width, row_stride, batch, clip;
    int vec, rows, threads, grid;
    unsigned rv_magic, rv_shift;
};

namespace {

constexpr int UNROLL = 8;
constexpr int MAX_ROWS = 2048;   // probe.py: GATHER_MAX_ROWS

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void set_nan(float& v) {
    v = __int_as_float(0x7fc00000);
}
__device__ __forceinline__ void set_nan(float2& v) {
    set_nan(v.x); set_nan(v.y);
}
__device__ __forceinline__ void set_nan(float4& v) {
    set_nan(v.x); set_nan(v.y); set_nan(v.z); set_nan(v.w);
}

template <int VEC>
__global__ void __launch_bounds__(256)
gather_rows_kernel(const float* __restrict__ table,
                   const int* __restrict__ idx, float* __restrict__ out,
                   const GatherLaunch p) {
    using T = typename Vec<VEC>::T;
    __shared__ int s_row[MAX_ROWS];
    const int b0 = blockIdx.x * p.rows;
    const int rows = min(p.rows, p.batch - b0);
    const int n = p.n_rows;
#pragma unroll 4
    for (int j = threadIdx.x; j < rows; j += blockDim.x) {
        const int r = __ldg(idx + b0 + j);
        const int w = r < 0 ? r + n : r;               // from the end
        s_row[j] = p.clip ? min(max(w, 0), n - 1)      // -1 when n == 0
                          : ((unsigned)w < (unsigned)n ? w : -1);
    }
    __syncthreads();
    const unsigned rv = (unsigned)p.width / VEC;       // vectors a row
    const unsigned total = (unsigned)rows * rv;
    const long long stride = p.row_stride / VEC;
    const T* tab = reinterpret_cast<const T*>(table);
    T* dst = reinterpret_cast<T*>(out + (long long)b0 * p.width);
    for (unsigned e0 = threadIdx.x; e0 < total;
         e0 += blockDim.x * UNROLL) {
        T v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const unsigned e = e0 + u * blockDim.x;
            if (e < total) {
                const unsigned r = udiv(e, p.rv_magic, p.rv_shift);
                const int src = s_row[r];
                if (src >= 0)
                    v[u] = __ldg(tab + src * stride + (e - r * rv));
                else
                    set_nan(v[u]);
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const unsigned e = e0 + u * blockDim.x;
            if (e < total) __stcs(dst + e, v[u]);
        }
    }
}

}  // namespace

extern "C" int vpt_gather_rows(const float* table, const int* idx,
                               float* out, const GatherLaunch* pp,
                               void* stream_) {
    const GatherLaunch& p = *pp;
    const cudaStream_t stream = (cudaStream_t)stream_;
    if (p.rows > MAX_ROWS) return (int)cudaErrorInvalidValue;
    switch (p.vec) {
        case 4: gather_rows_kernel<4><<<p.grid, p.threads, 0, stream>>>(
                    table, idx, out, p); break;
        case 2: gather_rows_kernel<2><<<p.grid, p.threads, 0, stream>>>(
                    table, idx, out, p); break;
        case 1: gather_rows_kernel<1><<<p.grid, p.threads, 0, stream>>>(
                    table, idx, out, p); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int vpt_gather_launch_size() {
    return (int)sizeof(GatherLaunch);
}
