// P2 — take_along_axis along axis 0 or 1 of an (N, C) float32 tensor,
// repeated ``iters`` times with an accumulate-and-reindex update:
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
// loop above, with all of x in VMEM).  Its plain PyTorch version is
// vpt_tpu_torch/ops/probe.py::take_along_plain; the launch (design,
// grid, strip, shared memory, dividers) is computed in Python by
// probe.py::take_along_design.
//
// What bounds it on the H100: at iters = 1, memory, but not its bytes:
// each element reads x at a random row, one 32-byte L2 sector for 4
// useful bytes.  At iters > 1, each chain's dependent steps (the next
// index needs this step's sum) and the integer work of each step,
// issued by every SM.
//
// What the design does about it (the launch is chosen in Python,
// probe.py::take_along_design, and passed as a ProbeLaunch):
// - 32-bit index math with no division in a step: (n, c) come from a
//   per-launch magic-number divider (umulhi, add, shift); the reindex
//   adds j, int32(acc) and i mod len and brings the sum back with two
//   unsigned min(s, s - len).  Only an int32(acc) outside [0, len) takes
//   the divider, behind one branch for all of a thread's chains so they
//   stay interleaved.  len <= 2^30 keeps the sum of three terms below
//   2^32 (the wrapper refuses more).  The reindex after the last step is
//   skipped.
// - Indices are read as jnp.take_along_axis reads them in the Pallas
//   bodies: uint32 as int32 (the same bits), one in [-len, 0) counting
//   from the end (first_index: one add, one unsigned compare).  One
//   outside [-len, len) makes the sum NaN from the first step, as reading
//   NaN does, and the chain walks row or column 0 instead of memory
//   outside x.
// - "smem_cols" (axis 0, iters > 1): x is staged in shared memory, the
//   counterpart of T5's x in VMEM, as strips of 8 whole columns (one
//   32-byte sector a row, so idx and out move whole sectors too; 4 where
//   8 do not fit), with cp.async; several blocks stage the same strip,
//   about one block per SM, each walking its share of the strip's
//   chains there.
// - "smem_rows" (axis 1, iters > 1): a block stages the whole rows its
//   chains lie in, ceil(N / 132) of them, and walks them there.
// - "global" (the rest, and where no strip fits): each thread takes 4
//   consecutive elements, idx read and out written as 16-byte vectors
//   when C % 4 == 0, x through the read-only path; at iters > 1 its 4
//   chains interleave.
// - A thread of the shared-memory designs walks 1 chain, or 2 or 4
//   interleaved where a block's chains outnumber 1024 threads.

#include <cuda_runtime.h>

#include "probe_launch.cuh"

namespace {

enum { GLOBAL = 0, SMEM_COLS = 1, SMEM_ROWS = 2 };

// One reindex step of G chains: j = (j + int32(acc) + im) mod len, with
// j, im in [0, len).  An int32(acc) outside [0, len) takes the divider;
// one branch for all G chains, so their steps stay interleaved.
template <int G>
__device__ __forceinline__ void reindex(unsigned (&j)[G],
                                        const float (&acc)[G], unsigned im,
                                        unsigned len, unsigned magic,
                                        unsigned shift) {
    unsigned r[G];
    bool slow = false;
#pragma unroll
    for (int g = 0; g < G; ++g) {
        r[g] = (unsigned)__float2int_rz(acc[g]);
        slow |= r[g] >= len;
    }
    if (slow) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
            // floor mod of a signed a: |a| or |a| - 1 is below 2^31
            const bool neg = (int)r[g] < 0;
            const unsigned u = neg ? ~r[g] : r[g];
            const unsigned m = u - udiv(u, magic, shift) * len;
            r[g] = r[g] < len ? r[g] : neg ? len - 1u - m : m;
        }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const unsigned s = j[g] + r[g] + im;
        const unsigned t = min(s, s - len);
        j[g] = min(t, t - len);
    }
}

__device__ __forceinline__ unsigned next_i(unsigned im, unsigned len) {
    im += 1u;
    return min(im, im - len);
}

// A chain's first index from its raw 32 bits: j in [0, len) and a zero
// sum, or row or column 0 and a NaN sum for an index outside [-len, len)
// (len <= 2^30, so raw + len wraps into [0, len) exactly for raw in
// [-len, 0)).
__device__ __forceinline__ void first_index(unsigned raw, unsigned len,
                                            unsigned& j, float& acc) {
    const unsigned w = raw + ((int)raw < 0 ? len : 0u);
    const bool ok = w < len;
    j = ok ? w : 0u;
    acc = ok ? 0.0f : __int_as_float(0x7fc00000);
}

// ---- global: 4 consecutive elements per thread, x from L2 -----------

template <typename I, bool VEC>
__global__ void __launch_bounds__(256)
take_along_global(const float* __restrict__ x, const I* __restrict__ idx,
                  float* __restrict__ out, const ProbeLaunch p) {
    const unsigned C = (unsigned)p.C, total = (unsigned)p.N * C;
    const unsigned len = (unsigned)(p.axis == 0 ? p.N : p.C);
    const unsigned e0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4u;
    if (e0 >= total) return;
    unsigned n = udiv(e0, p.c_magic, p.c_shift), c = e0 - n * C;
    unsigned raw[4], add[4];
    if (VEC) {
        const uint4 v = *reinterpret_cast<const uint4*>(idx + e0);
        raw[0] = v.x; raw[1] = v.y; raw[2] = v.z; raw[3] = v.w;
    }
    const unsigned mul = p.axis == 0 ? C : 1u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (!VEC) raw[k] = e0 + k < total ? (unsigned)idx[e0 + k] : 0u;
        add[k] = p.axis == 0 ? c + (VEC ? k : 0) : n * C;
        if (!VEC && ++c == C) { c = 0; ++n; }
    }
    float acc[4];
    unsigned j[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        first_index(raw[k], len, j[k], acc[k]);
        if (!VEC && e0 + k >= total) add[k] = 0u;  // in bounds, unused
    }
    unsigned im = 0;
    for (int i = 0;;) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
            acc[k] = acc[k] + __ldg(x + j[k] * mul + add[k]);
        if (++i == p.iters) break;
        reindex<4>(j, acc, im, len, p.len_magic, p.len_shift);
        im = next_i(im, len);
    }
    if (VEC) {
        *reinterpret_cast<float4*>(out + e0) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (e0 + k < total) out[e0 + k] = acc[k];
    }
}

// ---- smem_cols and smem_rows: chains walked from shared memory -------

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(s);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(a), "l"(g));
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(s);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(a), "l"(g));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
                 ::: "memory");
}

// AXIS 0: block (strip s, part t) stages columns [k s, k s + k) of all
// N rows as sm[row * k + cc] (k = p.strip, 8 or 4: 32 or 16 bytes of a
// row) and walks chains [t * per_block, ...) of the strip's N * k
// (chain q: row q / k, column k s + q % k).
// AXIS 1: block b stages rows [b * R, b * R + R) (R = per_block) as
// sm[row * C + c] and walks their chains (q: row q / C, column q % C).
// Thread t walks G chains at once, interleaved (p.chains: 1, 2 or 4, so
// that the block's chains fit 1024 threads): t, t + T, ..., then the next
// G T, so a warp's lanes read neighbouring idx and write neighbouring out.
template <int AXIS, bool VEC, int G>
__global__ void __launch_bounds__(1024)
take_along_smem(const float* __restrict__ x, const int* __restrict__ idx,
                float* __restrict__ out, const ProbeLaunch p) {
    extern __shared__ __align__(16) float sm[];
    const unsigned N = (unsigned)p.N, C = (unsigned)p.C;
    const unsigned len = AXIS == 0 ? N : C;
    const unsigned tid = threadIdx.x, T = blockDim.x;
    const unsigned k = (unsigned)p.strip, ks = k == 8 ? 3u : 2u;
    unsigned first, count, c0 = 0, cols = 0;
    if (AXIS == 0) {
        c0 = blockIdx.x * k;
        cols = min(k, C - c0);
        if (VEC) {  // cols is 4 or 8: one or two 16-byte pieces a row
            const unsigned ps = cols == 8 ? 1u : 0u;
            for (unsigned q = tid; q < N << ps; q += T) {
                const unsigned row = q >> ps, part = (q & ps) * 4u;
                cp_async16(sm + row * k + part, x + row * C + c0 + part);
            }
        } else {
            for (unsigned q = tid; q < N << ks; q += T) {
                const unsigned row = q >> ks, cc = q & (k - 1u);
                if (cc < cols)
                    cp_async4(sm + row * k + cc, x + row * C + c0 + cc);
            }
        }
        first = blockIdx.y * (unsigned)p.per_block;
        count = min((unsigned)p.per_block, (N << ks) - min(first, N << ks));
    } else {
        const unsigned r0 = blockIdx.x * (unsigned)p.per_block;
        const unsigned rows = min((unsigned)p.per_block, N - r0);
        const float* src = x + r0 * C;
        if (VEC) {
            for (unsigned q = tid * 4u; q < rows * C; q += T * 4u)
                cp_async16(sm + q, src + q);
        } else {
            for (unsigned q = tid; q < rows * C; q += T)
                cp_async4(sm + q, src + q);
        }
        first = r0 * C;
        count = rows * C;
    }
    cp_async_wait_all();
    __syncthreads();

    for (unsigned base = tid; base < count; base += G * T) {
        unsigned e[G], add[G], j[G];
        float acc[G];
        bool live[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const unsigned q = base + g * T;
            if (AXIS == 0) {
                const unsigned qq = first + q, cc = qq & (k - 1u);
                live[g] = q < count && cc < cols;
                e[g] = (qq >> ks) * C + c0 + cc;
                add[g] = cc;
            } else {
                live[g] = q < count;
                e[g] = first + q;
                add[g] = udiv(q, p.c_magic, p.c_shift) * C;
            }
            // a dead slot walks row or column 0 of the strip and is not
            // stored
            first_index(live[g] ? (unsigned)idx[e[g]] : 0u, len, j[g],
                        acc[g]);
            if (!live[g]) add[g] = 0u;
        }
        unsigned im = 0;
        for (int i = 0;;) {
#pragma unroll
            for (int g = 0; g < G; ++g)
                acc[g] = acc[g] + sm[(AXIS == 0 ? j[g] << ks : j[g]) + add[g]];
            if (++i == p.iters) break;
            reindex<G>(j, acc, im, len, p.len_magic, p.len_shift);
            im = next_i(im, len);
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
            if (live[g]) out[e[g]] = acc[g];
    }
}

template <typename I>
int launch_global(const float* x, const I* idx, float* out,
                  const ProbeLaunch& p, cudaStream_t stream) {
    const dim3 grid(p.grid_x, p.grid_y), block(p.threads);
    if (p.vec)
        take_along_global<I, true><<<grid, block, 0, stream>>>(x, idx, out,
                                                               p);
    else
        take_along_global<I, false><<<grid, block, 0, stream>>>(x, idx, out,
                                                                p);
    return (int)cudaGetLastError();
}

// Raise a kernel's dynamic shared-memory limit to the launch's bytes
// where they pass what it allows on this device (cudaFuncSetAttribute is
// a host call, so only then).
template <int AXIS, bool VEC, int G>
cudaError_t allow_smem(int bytes) {
    static int allowed[32] = {};  // per device; 0: the 48 KB default
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || dev >= 32 || bytes <= allowed[dev]) return err;
    err = cudaFuncSetAttribute(take_along_smem<AXIS, VEC, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err == cudaSuccess) allowed[dev] = bytes;
    return err;
}

template <int AXIS, bool VEC, int G>
int launch_smem(const float* x, const int* idx, float* out,
                const ProbeLaunch& p, cudaStream_t stream) {
    if (p.smem > 48 * 1024) {
        const cudaError_t err = allow_smem<AXIS, VEC, G>(p.smem);
        if (err != cudaSuccess) return (int)err;
    }
    take_along_smem<AXIS, VEC, G>
        <<<dim3(p.grid_x, p.grid_y), p.threads, p.smem, stream>>>(
            x, idx, out, p);
    return (int)cudaGetLastError();
}

template <int AXIS, bool VEC>
int launch_smem(const float* x, const int* idx, float* out,
                const ProbeLaunch& p, cudaStream_t stream) {
    switch (p.chains) {
        case 1: return launch_smem<AXIS, VEC, 1>(x, idx, out, p, stream);
        case 2: return launch_smem<AXIS, VEC, 2>(x, idx, out, p, stream);
        case 4: return launch_smem<AXIS, VEC, 4>(x, idx, out, p, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" int vpt_take_along_i32(const float* x, const int* idx,
                                  float* out, const ProbeLaunch* pp,
                                  void* stream_) {
    const ProbeLaunch& p = *pp;
    const cudaStream_t stream = (cudaStream_t)stream_;
    switch (p.design * 2 + p.vec) {
        case SMEM_COLS * 2: return launch_smem<0, false>(x, idx, out, p,
                                                         stream);
        case SMEM_COLS * 2 + 1: return launch_smem<0, true>(x, idx, out, p,
                                                            stream);
        case SMEM_ROWS * 2: return launch_smem<1, false>(x, idx, out, p,
                                                         stream);
        case SMEM_ROWS * 2 + 1: return launch_smem<1, true>(x, idx, out, p,
                                                            stream);
        default: return launch_global<int>(x, idx, out, p, stream);
    }
}

// uint32 indices take one step, which is always the global design.
extern "C" int vpt_take_along_u32(const float* x, const unsigned* idx,
                                  float* out, const ProbeLaunch* pp,
                                  void* stream) {
    if (pp->design != GLOBAL) return (int)cudaErrorInvalidValue;
    return launch_global<unsigned>(x, idx, out, *pp, (cudaStream_t)stream);
}

extern "C" int vpt_probe_launch_size() { return (int)sizeof(ProbeLaunch); }

// What take_along_design shapes the launch for: the device's SMs and the
// dynamic shared memory one block may opt into.
extern "C" int vpt_device_limits(int device, int* sms, int* smem_optin) {
    cudaError_t err = cudaDeviceGetAttribute(
        sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    return (int)err;
}
