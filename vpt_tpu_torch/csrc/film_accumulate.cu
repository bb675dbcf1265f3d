// K3 — film accumulation: one progressive step of the film's running
// means, with the NaN scrub, in one pass over the pixels.
//
// Replaces: vpt_tpu/render/film.py::accumulate with scrub_nan (an XLA
// program; render_kernel.cu:2263-2287 in the reference).  Its plain
// PyTorch version is vpt_tpu_torch/render/film.py::accumulate_plain, and
// its wrapper ``accumulate`` in the same module.
//
// Per pixel, with inv = 1 / (iteration + 1) in float32:
//   value  = value if all 3 components are finite, else film.accum
//            (QUIRKS #18: a non-finite component keeps the whole pixel)
//   alpha  = alpha if finite, else 1.0
//   accum' = accum + (value - accum) * inv, alpha' and depth' alike,
//   cost'  = cost + cost_sample, trunc' = trunc + trunc_sample.
// depth, cost and trunc may each be absent (FIELD_* bits): the wrapper
// carries the film's field over and the kernel neither reads nor writes
// it.  Built with -fmad=false: each multiply and add rounds on its own,
// as accumulate_plain's one-op passes do, so the result is bit for bit
// accumulate_plain's.
//
// What bounds it on the H100: bytes — it reads 14 and writes 7 float32 a
// pixel (84 B), 174 MB at 1080p, against a handful of flops: 0.052 ms at
// 3.35 TB/s.
//
// What the design does about it: each thread takes a group of 4 pixels
// with 16-byte accesses only: their RGB is 48 B, 3 float4 each of value,
// accum and accum'; one float4 each of the other fields; 14 float4 loads,
// all issued before the first store, and 7 float4 stores.  Many blocks
// (2025 of 256 threads at 1080p) keep the loads in flight: 2 groups a
// thread, or blocks of 128 or 512 threads, measured no faster.  Every
// load takes the read-only path; streaming loads (__ldcs) on the once-read
// sample measured slower.  The main path gives all fields: that case is
// compiled without the per-field branches.  A scalar tail takes the last
// H*W mod 4 pixels.  A tensor that does not start on a 16-byte boundary
// (a contiguous view into a larger buffer) takes the scalar route, one
// pixel a thread in single-float accesses, the same arithmetic: the
// wrapper picks the route from the pointers
// (render/film.py::accumulate_design).

#include <cuda_runtime.h>

// Mirrored by vpt_tpu_torch/render/film.py::_FilmArgs.
struct FilmArgs {
    const float *acc, *alpha, *depth, *cost, *trunc;   // the film
    const float *v, *a, *d, *c, *t;                     // the sample
    float *o_acc, *o_alpha, *o_depth, *o_cost, *o_trunc;
    int n, fields, vec;   // vec: every pointer 16-byte aligned
    float inv;
};

namespace {

enum { FIELD_DEPTH = 1, FIELD_COST = 2, FIELD_TRUNC = 4 };

__device__ __forceinline__ bool finite(float x) {
    return fabsf(x) <= 3.402823466e38f;   // false for NaN and +-Inf
}

__device__ __forceinline__ float mean_step(float f, float s, float inv) {
    return f + (s - f) * inv;
}

__device__ __forceinline__ float4 ld(const float* p, unsigned i) {
    return __ldg(reinterpret_cast<const float4*>(p) + i);
}

__device__ __forceinline__ void st(float* p, unsigned i, float4 v) {
    reinterpret_cast<float4*>(p)[i] = v;
}

// RGB of one pixel: the scrub, then the running mean
__device__ __forceinline__ void rgb(const float* v, const float* a,
                                    float* o, float inv) {
    const bool ok = finite(v[0]) && finite(v[1]) && finite(v[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
        o[k] = mean_step(a[k], ok ? v[k] : a[k], inv);
}

__device__ __forceinline__ float alpha_step(float f, float s, float inv) {
    return mean_step(f, finite(s) ? s : 1.0f, inv);
}

// pixel i in single floats: the scalar tail of the float4 route, and the
// scalar route
__device__ __forceinline__ void pixel(const FilmArgs& p, int i, float inv,
                                      bool depth, bool cost, bool trunc) {
    float v[3], a[3], o[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        v[k] = __ldg(p.v + 3 * i + k);
        a[k] = __ldg(p.acc + 3 * i + k);
    }
    rgb(v, a, o, inv);
#pragma unroll
    for (int k = 0; k < 3; ++k) p.o_acc[3 * i + k] = o[k];
    p.o_alpha[i] = alpha_step(__ldg(p.alpha + i), __ldg(p.a + i), inv);
    if (depth)
        p.o_depth[i] = mean_step(__ldg(p.depth + i), __ldg(p.d + i), inv);
    if (cost) p.o_cost[i] = __ldg(p.cost + i) + __ldg(p.c + i);
    if (trunc) p.o_trunc[i] = __ldg(p.trunc + i) + __ldg(p.t + i);
}

// the scalar route: one pixel a thread
__global__ void __launch_bounds__(256) film_accumulate_scalar(FilmArgs p) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.n) return;
    pixel(p, i, p.inv, p.fields & FIELD_DEPTH, p.fields & FIELD_COST,
          p.fields & FIELD_TRUNC);
}

template <bool ALL>   // all of depth, cost and trunc given
__global__ void __launch_bounds__(256) film_accumulate_kernel(FilmArgs p) {
    const unsigned g = blockIdx.x * blockDim.x + threadIdx.x;
    const unsigned groups = (unsigned)p.n / 4;
    const float inv = p.inv;
    const bool depth = ALL || (p.fields & FIELD_DEPTH);
    const bool cost = ALL || (p.fields & FIELD_COST);
    const bool trunc = ALL || (p.fields & FIELD_TRUNC);
    if (g < groups) {
        float4 v4[3], a4[3], o4[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            v4[k] = ld(p.v, 3 * g + k);
            a4[k] = ld(p.acc, 3 * g + k);
        }
        const float4 sa = ld(p.a, g), fa = ld(p.alpha, g);
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 sd = z, fd = z, sc = z, fc = z, st_ = z, ft = z;
        if (depth) {
            sd = ld(p.d, g);
            fd = ld(p.depth, g);
        }
        if (cost) {
            sc = ld(p.c, g);
            fc = ld(p.cost, g);
        }
        if (trunc) {
            st_ = ld(p.t, g);
            ft = ld(p.trunc, g);
        }
        const float* v = reinterpret_cast<const float*>(v4);
        const float* a = reinterpret_cast<const float*>(a4);
        float* o = reinterpret_cast<float*>(o4);
#pragma unroll
        for (int q = 0; q < 4; ++q) rgb(v + 3 * q, a + 3 * q, o + 3 * q, inv);
#pragma unroll
        for (int k = 0; k < 3; ++k) st(p.o_acc, 3 * g + k, o4[k]);
        st(p.o_alpha, g, make_float4(
            alpha_step(fa.x, sa.x, inv), alpha_step(fa.y, sa.y, inv),
            alpha_step(fa.z, sa.z, inv), alpha_step(fa.w, sa.w, inv)));
        if (depth)
            st(p.o_depth, g, make_float4(
                mean_step(fd.x, sd.x, inv), mean_step(fd.y, sd.y, inv),
                mean_step(fd.z, sd.z, inv), mean_step(fd.w, sd.w, inv)));
        if (cost)
            st(p.o_cost, g, make_float4(fc.x + sc.x, fc.y + sc.y,
                                        fc.z + sc.z, fc.w + sc.w));
        if (trunc)
            st(p.o_trunc, g, make_float4(ft.x + st_.x, ft.y + st_.y,
                                         ft.z + st_.z, ft.w + st_.w));
        return;
    }
    if (g != groups) return;
    // the scalar tail: pixels 4 groups .. n - 1
    for (int i = 4 * (int)groups; i < p.n; ++i)
        pixel(p, i, inv, depth, cost, trunc);
}

}  // namespace

extern "C" int vpt_film_accumulate(const FilmArgs* pp, void* stream) {
    const FilmArgs& p = *pp;
    if (p.n <= 0) return 0;
    const int threads = 256;
    const cudaStream_t s = (cudaStream_t)stream;
    if (!p.vec) {
        film_accumulate_scalar<<<(p.n + threads - 1) / threads, threads, 0,
                                 s>>>(p);
        return (int)cudaGetLastError();
    }
    const int blocks = (p.n / 4 + 1 + threads - 1) / threads;
    if (p.fields == (FIELD_DEPTH | FIELD_COST | FIELD_TRUNC))
        film_accumulate_kernel<true><<<blocks, threads, 0, s>>>(p);
    else
        film_accumulate_kernel<false><<<blocks, threads, 0, s>>>(p);
    return (int)cudaGetLastError();
}

extern "C" int vpt_film_args_size() { return (int)sizeof(FilmArgs); }
